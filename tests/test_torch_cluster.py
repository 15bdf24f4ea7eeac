"""The PyTorch port's cluster tier (horaedb_tpu_torch/cluster: router,
cluster, remote, and storage/combine.merge_downsample_results) against
the JAX package's, on the CPU.

`routing_key` agrees on seeded label sets; a RoutingTable's JSON crosses
between the packages both ways and routes alike; the cross-region merge
gives equal bytes on seeded grids, overlapping tsids and aggregate
subsets included.  A 3-region cluster with one region remote (behind
each package's own server, through RemoteRegion) gathers grids, rows and
label values equal to the JAX package's cluster on the same writes
(both on the parts route, HORAEDB_FUSED_AGG=0, and the JAX package with
HORAEDB_HOST_AGG=0 so its partial sums are float32 like the port's).
Then the stale-owner retry, health and breakers, split, detach and
adopt, and the rebalance plan.  No test waits on wall time."""

import asyncio
from types import SimpleNamespace

import aiohttp
import aiohttp.web
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

import horaedb_tpu.cluster as ref_cluster
import horaedb_tpu.server.config as ref_cfg
import horaedb_tpu.server.main as ref_main
from horaedb_tpu.metric_engine import Label as RefLabel
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.metric_engine import Sample as RefSample
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage import combine as ref_combine
from horaedb_tpu.storage.types import TimeRange as RefRange
import horaedb_tpu_torch.cluster as port_cluster
from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.server import config as port_cfg
from horaedb_tpu_torch.server import main as port_main
from horaedb_tpu_torch.storage import combine
from horaedb_tpu_torch.storage.types import TimeRange

T0 = 1_700_000_000_000
HOUR = 3_600_000
DAY = 24 * HOUR

REF = SimpleNamespace(cl=ref_cluster, engine=RefEngine, store=RefStore,
                      label=RefLabel, sample=RefSample, tr=RefRange,
                      main=ref_main, cfg=ref_cfg, kw={})
PORT = SimpleNamespace(cl=port_cluster, engine=MetricEngine,
                       store=MemoryObjectStore, label=Label, sample=Sample,
                       tr=TimeRange, main=port_main, cfg=port_cfg,
                       kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def parts_route(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")


def run(coro):
    return asyncio.run(coro)


def _label_sets(seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        labels = sorted({f"k{int(rng.integers(0, 9))}":
                         f"v{int(rng.integers(0, 10**6))}"
                         for _ in range(k)}.items())
        out.append((f"m{int(rng.integers(0, 5))}", labels))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_routing_key_agrees(seed):
    for metric, labels in _label_sets(seed):
        ref = ref_cluster.routing_key(
            metric, [RefLabel(k, v) for k, v in labels])
        got = port_cluster.routing_key(
            metric, [Label(k, v) for k, v in labels])
        assert got == ref and 0 <= got < port_cluster.router.KEY_SPACE


def _split_table(pkg):
    rt = pkg.cl.RoutingTable.uniform([0, 1, 2])
    rt.split(1, (1 << 62) + 12345, 7, now_ms=T0 + DAY,
             table_ttl_ms=30 * DAY)
    rt.split(7, (1 << 62) + (1 << 60), 8, now_ms=T0 + 2 * DAY,
             table_ttl_ms=DAY)
    return rt


def _routes(rt, seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 63, 200, dtype=np.uint64).tolist()
    out = []
    for k in keys:
        out.append(rt.route_write(int(k), T0 + 3 * DAY))
        out.append(rt.route_query(int(k), T0, T0 + DAY))
    out.append(rt.route_query(None, T0 + 40 * DAY, T0 + 41 * DAY))
    out.append(rt.region_ids())
    return out


@pytest.mark.parametrize("strict", [False, True])
def test_routing_table_json_crosses_both_ways(strict):
    ref = _split_table(REF)
    port = _split_table(PORT)
    ref.strict_time_routing = port.strict_time_routing = strict
    assert ref.to_json() == port.to_json()
    from_ref = port_cluster.RoutingTable.from_json(ref.to_json())
    from_port = ref_cluster.RoutingTable.from_json(port.to_json())
    assert from_ref.to_json() == ref.to_json()
    assert from_port.to_json() == port.to_json()
    assert _routes(from_ref, 1) == _routes(ref, 1)
    assert _routes(from_port, 2) == _routes(port, 2)
    dead_r = [r.region_id for r in from_ref.gc_expired(T0 + 10 * DAY)]
    dead_p = [r.region_id for r in from_port.gc_expired(T0 + 10 * DAY)]
    assert dead_r == dead_p == [7]
    with pytest.raises(port_cluster.router.Error):
        from_ref.split(0, 0, 9, T0, DAY)


def _region_result(rng, tsids, nb, which):
    g = len(tsids)
    count = rng.integers(0, 3, (g, nb)).astype(np.float64)
    empty = count == 0
    vals = rng.standard_normal((g, nb)) * 10
    aggs = {"count": count}
    if "sum" in which:
        aggs["sum"] = np.where(empty, 0.0, vals * count)
    if "avg" in which:
        aggs["avg"] = np.where(empty, np.nan, vals)
    if "min" in which:
        aggs["min"] = np.where(empty, np.inf, vals - 1)
    if "max" in which:
        aggs["max"] = np.where(empty, -np.inf, vals + 1)
    if "last" in which:
        aggs["last"] = np.where(empty, np.nan, vals * 0.5)
        aggs["last_ts"] = np.where(
            empty, np.nan,
            rng.integers(0, 1000, (g, nb)).astype(np.float64))
    return {"tsids": list(tsids), "num_buckets": nb, "aggs": aggs}


WHICH = (("avg",), ("count",), ("min", "max"), ("sum", "avg"),
         ("avg", "last"), ("sum", "min", "max", "avg", "last"))


@pytest.mark.parametrize("which", WHICH, ids=["+".join(w) for w in WHICH])
@pytest.mark.parametrize("seed", range(2))
def test_merge_downsample_results_bytes(which, seed):
    """Overlapping tsids across regions (a split's TTL window), empty
    regions, an avg-only region whose sum is rebuilt, and `which`
    given or inferred."""
    rng = np.random.default_rng(seed)
    nb = 12
    results = [
        _region_result(rng, [5, 9, 2**60 + 3], nb, which),
        _region_result(rng, [9, 11], nb, which),
        {"tsids": [], "num_buckets": nb, "aggs": {}},
        _region_result(rng, [2**60 + 3, 1], nb, which),
    ]
    if "avg" in which and "sum" not in which:
        results.append(_region_result(rng, [5, 77], nb, ("avg",)))
    for w in (None, which):
        ref = ref_combine.merge_downsample_results(results, nb, w)
        got = combine.merge_downsample_results(results, nb, w)
        assert got["tsids"] == ref["tsids"]
        assert got["num_buckets"] == ref["num_buckets"]
        assert sorted(got["aggs"]) == sorted(ref["aggs"])
        for k, grid in ref["aggs"].items():
            assert got["aggs"][k].dtype == grid.dtype, k
            assert got["aggs"][k].tobytes() == grid.tobytes(), k
    empty = combine.merge_downsample_results(results[2:3], nb)
    assert empty == ref_combine.merge_downsample_results(results[2:3], nb)


def _writes(pkg, seed: int, n: int = 600, hosts: int = 40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h = int(rng.integers(0, hosts))
        out.append(pkg.sample(
            "cpu", [pkg.label("dc", "east" if h % 3 else "west"),
                    pkg.label("host", f"h{h:03d}")],
            int(T0 + rng.integers(0, 4 * HOUR)),
            float(np.round(rng.random() * 100, 3))))
    return out


class _Remote:
    """One region's engine behind its package's server, reached through
    that package's RemoteRegion."""

    def __init__(self, pkg, spy=None):
        self.pkg = pkg
        self.spy = spy

    async def start(self):
        pkg = self.pkg
        self.engine = await pkg.engine.open("remote_db", pkg.store(),
                                            segment_ms=2 * HOUR, **pkg.kw)
        self.state = pkg.main.ServerState(self.engine,
                                          pkg.cfg.ServerConfig())
        app = pkg.main.build_app(self.state)
        if self.spy is not None:
            app.middlewares.insert(0, self.spy)
        self.server = TestServer(app)
        await self.server.start_server()
        self.session = aiohttp.ClientSession()
        self.region = pkg.cl.RemoteRegion(str(self.server.make_url("/")),
                                          self.session)
        return self.region

    async def stop(self):
        await self.region.close()
        await self.session.close()
        await self.server.close()
        await self.engine.close()


def _grid_bytes(out):
    return ([str(t) for t in out["tsids"]], out["num_buckets"],
            {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
             for k, v in sorted(out["aggs"].items())})


def _rows(tbl):
    return sorted(zip(tbl.column("tsid").to_pylist(),
                      tbl.column("timestamp").to_pylist(),
                      tbl.column("value").to_pylist()))


async def _gather_session(pkg, seed: int) -> list:
    remote = _Remote(pkg)
    region = await remote.start()
    c = await pkg.cl.Cluster.open("cluster", pkg.store(), num_regions=2,
                                  segment_ms=2 * HOUR, **pkg.kw)
    out = []
    try:
        # a third region, served remotely, owns the top quarter of the
        # key space
        c.routing.split(1, 3 << 61, 2, T0, 30 * DAY)
        c.add_remote_region(2, region)
        await c.write(_writes(pkg, seed))
        rng = pkg.tr.new(T0, T0 + 4 * HOUR)
        for filters in ([], [("dc", "west")], [("host", "h003")]):
            ds, meta = await c.query_downsample_gather(
                "cpu", filters, rng, 15 * 60_000)
            out.append((_grid_bytes(ds), meta.partial,
                        meta.missing_regions))
            strict = await c.query_downsample("cpu", filters, rng,
                                              15 * 60_000)
            assert _grid_bytes(strict) == _grid_bytes(ds)
            tbl, meta = await c.query_gather("cpu", filters, rng)
            out.append((_rows(tbl), meta.partial))
        vals, meta = await c.label_values_gather("cpu", "host", rng)
        out.append((vals, meta.partial))
        out.append(await c.label_values("cpu", "dc", rng))
        # the remote engine really took traffic over HTTP
        out.append((await remote.engine.query("cpu", [], rng)).num_rows)
        stats = await c.region_stats()
        out.append({r: (s["rows"], s["rules"], s["remote"])
                    for r, s in stats.items()})
        out.append(c.region_loads())
        out.append(await c.check_health_once())
        out.append(c.breaker_states())
        return out
    finally:
        await c.close()
        await remote.stop()


@pytest.mark.parametrize("seed", range(2))
def test_three_region_gather_with_a_remote_region(seed):
    async def go():
        return (await _gather_session(REF, seed),
                await _gather_session(PORT, seed))

    ref, port = run(go())
    assert ref == port
    assert port[-5] > 0 and port[0][0][0], "every region took rows"


class _StaleBackend:
    """A region backend whose reads answer 409 stale-owner."""

    def __init__(self, pkg, region, owner=None):
        self.err = pkg.cl.StaleOwnerError
        self.region = region
        self.owner = owner

    def _raise(self):
        raise self.err(f"region {self.region} moved", region=self.region,
                       owner=self.owner)

    async def query(self, *a, **kw):
        self._raise()

    async def query_downsample(self, *a, **kw):
        self._raise()

    async def label_values(self, *a, **kw):
        self._raise()

    async def close(self):
        pass


async def _stale_session(pkg) -> list:
    c = await pkg.cl.Cluster.open("cluster", pkg.store(), num_regions=2,
                                  segment_ms=2 * HOUR, **pkg.kw)
    real0, real = c.regions[0], c.regions[1]
    out = []
    try:
        await c.write([pkg.sample("cpu", [pkg.label("host", f"h{i:03d}")],
                                  T0 + 1000, float(i)) for i in range(32)])
        rng = pkg.tr.new(T0, T0 + HOUR)
        # no resolver: the 409 degrades to a partial answer
        c.repoint_region(1, _StaleBackend(pkg, 1))
        tbl, meta = await c.query_gather("cpu", [], rng)
        out.append((tbl.num_rows, meta.partial, meta.missing_regions,
                    meta.errors))
        ds, meta = await c.query_downsample_gather("cpu", [], rng, 60_000)
        out.append((len(ds["tsids"]), meta.partial))
        # a resolver that fails also degrades
        async def broken(rid, exc):
            raise RuntimeError("resolver down")
        c.owner_resolver = broken
        _tbl, meta = await c.query_gather("cpu", [], rng)
        out.append((meta.partial, meta.missing_regions))
        # one routed retry against the re-resolved owner heals it
        resolved = []

        async def resolver(rid, exc):
            resolved.append((rid, exc.owner))
            return real

        c.repoint_region(1, _StaleBackend(pkg, 1, owner="node-b"))
        c.owner_resolver = resolver
        tbl, meta = await c.query_gather("cpu", [], rng)
        out.append((tbl.num_rows, meta.partial, resolved,
                    c.regions[1] is real))
        # every region stale and no owner: a hard error, not partial
        c.owner_resolver = None
        c.repoint_region(0, _StaleBackend(pkg, 0))
        c.repoint_region(1, _StaleBackend(pkg, 1))
        try:
            await c.query_gather("cpu", [], rng)
            out.append("no error")
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append(type(e).__name__)
        return out
    finally:
        # the real engines go back so close() closes them
        c.regions[0], c.regions[1] = real0, real
        await c.close()


def test_stale_owner_retry_and_partial_answers():
    async def go():
        return await _stale_session(REF), await _stale_session(PORT)

    ref, port = run(go())
    assert ref == port
    assert port[0][1] is True and port[3][:2] == (32, False)


async def _health_session(pkg) -> list:
    """A remote region whose server goes away: two failed pings mark it
    dead, gathers skip it (partial), strict queries and writes fail
    fast, and a fresh backend clears the mark."""
    remote = _Remote(pkg)
    region = await remote.start()
    c = await pkg.cl.Cluster.open("cluster", pkg.store(), num_regions=1,
                                  segment_ms=2 * HOUR, **pkg.kw)
    out = []
    try:
        await c.stop_health_monitor()   # rounds are driven by hand
        c.routing.split(0, 1 << 62, 5, T0, 30 * DAY)
        c.add_remote_region(5, region)
        await c.stop_health_monitor()
        await c.write(_writes(pkg, 3, n=80))
        rng = pkg.tr.new(T0, T0 + 4 * HOUR)
        out.append(await c.check_health_once())
        await remote.server.close()
        for _ in range(2):
            out.append(await c.check_health_once())
        out.append((sorted(c.dead_regions), c.breaker_states()))
        _tbl, meta = await c.query_gather("cpu", [], rng)
        out.append((meta.partial, meta.missing_regions,
                    sorted(meta.errors)))
        for call in (c.query("cpu", [], rng),
                     c.write(_writes(pkg, 4, n=20))):
            try:
                await call
                out.append("no error")
            except Exception as e:  # noqa: BLE001 — compared across
                out.append("DEAD" in str(e))
        backlog = c._health_backlog()
        out.append((backlog["dead_regions"],
                    sorted(backlog["consecutive_fails"]),
                    sorted(backlog["last_errors"])))
        # detach the dead remote and adopt the region locally
        await c.detach_region(5)
        await c.adopt_region(5)
        out.append((sorted(c.dead_regions), 5 in c.breakers,
                    type(c.regions[5]).__name__))
        _tbl, meta = await c.query_gather("cpu", [], rng)
        out.append(meta.partial)
        return out
    finally:
        await c.close()
        await remote.session.close()
        await remote.region.close()
        await remote.engine.close()


def test_health_marks_dead_and_adopt_clears():
    async def go():
        return await _health_session(REF), await _health_session(PORT)

    ref, port = run(go())
    assert ref == port
    assert port[0] == {5: True} and port[3][0] == [5]


async def _split_session(pkg) -> list:
    store = pkg.store()
    c = await pkg.cl.Cluster.open("cluster", store, num_regions=2,
                                  segment_ms=2 * HOUR, **pkg.kw)
    out = []
    try:
        await c.write(_writes(pkg, 11, n=300))
        rng = pkg.tr.new(T0, T0 + 4 * HOUR)
        before, _ = await c.query_downsample_gather("cpu", [], rng, HOUR)
        pivot = c.split_pivot(0)
        out.append(pivot)
        await c.split_region(0, pivot, 4, table_ttl_ms=30 * DAY)
        after, meta = await c.query_downsample_gather("cpu", [], rng, HOUR)
        assert _grid_bytes(after) == _grid_bytes(before)
        out.append((_grid_bytes(after), meta.partial, sorted(c.regions)))
        await c.write(_writes(pkg, 12, n=100))
        out.append(_grid_bytes(await c.query_downsample("cpu", [], rng,
                                                        HOUR)))
        stats = {0: {"bytes": 900, "rules": 2}, 1: {"bytes": 100,
                                                    "rules": 1},
                 4: {"bytes": 50, "rules": 1}, 3: {"bytes": -1,
                                                   "rules": 0}}
        out.append(c._rebalance_from_stats(stats, 2.0))
        # split times come from the wall clock: compare the key ranges
        out.append(sorted((r.start_key, r.end_key, r.region_id)
                          for r in c.routing.rules))
    finally:
        await c.close()
    # reopening reads the persisted routing table
    c2 = await pkg.cl.Cluster.open("cluster", store, segment_ms=2 * HOUR,
                                   **pkg.kw)
    try:
        out.append(sorted(c2.regions))
        rng = pkg.tr.new(T0, T0 + 4 * HOUR)
        out.append(_grid_bytes(await c2.query_downsample("cpu", [], rng,
                                                         HOUR)))
    finally:
        await c2.close()
    return out


def test_split_keeps_the_gather_unchanged():
    async def go():
        return await _split_session(REF), await _split_session(PORT)

    ref, port = run(go())
    assert ref == port
    assert [e["kind"] for e in port[3]] == ["split"]


def test_cluster_reopens_from_persisted_routing():
    async def go():
        store = MemoryObjectStore()
        c = await port_cluster.Cluster.open("cl", store, num_regions=2,
                                            segment_ms=2 * HOUR,
                                            device="cpu")
        try:
            await c.split_region(1, (1 << 62) + 7, 3, DAY)
            saved = c.routing.to_json()
        finally:
            await c.close()
        c2 = await port_cluster.Cluster.open("cl", store,
                                             segment_ms=2 * HOUR,
                                             device="cpu")
        try:
            assert c2.routing.to_json() == saved
            assert sorted(c2.regions) == [0, 1, 3]
            assert all(e.device.type == "cpu" for e in c2.regions.values())
        finally:
            await c2.close()

    run(go())


def test_remote_region_propagates_deadline_and_tenant():
    """RemoteRegion's RPCs carry the ambient deadline and tenant: the
    port's server sees them (a spent budget is refused before the RPC),
    and a 409 from the peer maps to StaleOwnerError."""
    from horaedb_tpu_torch.common.deadline import (Deadline,
                                                   DeadlineExceeded,
                                                   deadline_scope)
    from horaedb_tpu_torch.common.tenant import (TenantRegistry,
                                                 tenant_scope,
                                                 tenants_from_dict)

    async def go():
        seen = []

        @aiohttp.web.middleware
        async def spy(request, handler):
            seen.append((request.path, request.headers.get("X-Tenant"),
                         request.headers.get("X-Tenant-Weight"),
                         request.headers.get("X-Deadline-Ms")))
            return await handler(request)

        remote = _Remote(PORT, spy)
        region = await remote.start()
        try:
            rng = TimeRange.new(T0, T0 + HOUR)
            reg = TenantRegistry(tenants_from_dict({
                "enabled": True, "tenant": {"gold": {"weight": 4.0}}}))
            with tenant_scope(reg.resolve("gold")), \
                    deadline_scope(Deadline.after(30.0)):
                await region.write(_writes(PORT, 5, n=10))
                await region.query_downsample("cpu", [], rng, 60_000)
            spent = Deadline.after(0.0)
            with deadline_scope(spent):
                with pytest.raises(DeadlineExceeded):
                    await region.query("cpu", [], rng)
            remote.state.stale_owner = {"region": 2, "epoch": 3,
                                        "reason": "lost"}
            with pytest.raises(port_cluster.StaleOwnerError) as exc:
                await region.query("cpu", [], rng)
            assert exc.value.region == 2
            with pytest.raises(port_cluster.StaleOwnerError):
                await region.label_values("cpu", "host", rng)
            assert await region.ping() is True
        finally:
            await remote.stop()
        paths = [s[0] for s in seen]
        assert paths[:2] == ["/write", "/query_arrow"]
        for _path, tenant, weight, dl in seen[:2]:
            assert tenant == "gold" and weight == "4.0"
            assert dl is not None and 0 < int(dl) <= 30_000

    run(go())


def test_gather_on_the_fused_route_merges_host_grids(monkeypatch):
    """A local region's fused route hands back device tensors; the
    gather merges them as host arrays, equal to merging each region's
    direct result by hand."""
    monkeypatch.delenv("HORAEDB_FUSED_AGG")

    async def go():
        c = await port_cluster.Cluster.open(
            "cluster", MemoryObjectStore(), num_regions=3,
            segment_ms=2 * HOUR, device="cpu")
        try:
            await c.write(_writes(PORT, 21, n=300))
            rng = TimeRange.new(T0, T0 + 4 * HOUR)
            parts = [await e.query_downsample("cpu", [], rng, HOUR)
                     for e in c.regions.values()]
            assert any(hasattr(v, "cpu") for p in parts
                       for v in p["aggs"].values())
            out, meta = await c.query_downsample_gather("cpu", [], rng,
                                                        HOUR)
        finally:
            await c.close()
        host = [{**p, "aggs": {k: (v.numpy() if hasattr(v, "cpu") else v)
                               for k, v in p["aggs"].items()}}
                for p in parts]
        want = combine.merge_downsample_results(host, 4)
        assert not meta.partial
        assert _grid_bytes(out) == _grid_bytes(want)
        assert all(isinstance(v, np.ndarray) for v in out["aggs"].values())

    run(go())
