"""Near-data scan agents in the PyTorch port (horaedb_tpu_torch/scanagent,
cluster/breaker.py and the router in storage/read.py), held against the
JAX package on the CPU.

The scenarios of tests/test_scanagent.py run on the port: agent-served
aggregate grids byte-compared with the direct scan across aggregate
sets, filters and top-k; partial coverage; the memo; an agent killed
mid-gather; the breaker and its half-open probe; a stale shard map; an
oversized partial; the degraded gather; 504 on an expired deadline; 429
on a tenant quota; trace stitching; and the fast seeded chaos schedules.
The port's CPU tests otherwise keep the fused route, so the direct-scan
control here runs with HORAEDB_FUSED_AGG=0 — the parts route, whose
grids are the combine's, as an agent-routed scan's are.

Across packages: the wire bytes of the same parts and request, and one
scan each way — the port's coordinator served by the JAX package's
agent and the JAX package's coordinator served by the port's agent —
whose grids must equal each package's own direct scan byte for byte
(both packages on the parts route, the JAX one with HORAEDB_HOST_AGG=0 so
its partial sums are float32 like the port's)."""

import asyncio
import json
import random

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu_torch.common import ReadableDuration
from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.deadline import (Deadline, DeadlineExceeded,
                                               deadline_scope)
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.common.tenant import (QuotaExceeded, TenantRegistry,
                                             tenant_scope, tenants_from_dict)
from horaedb_tpu_torch.objstore import (FaultInjectingStore,
                                        InstrumentedStore, MemoryObjectStore)
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.scanagent import (AgentService, AgentSpec,
                                         ScanAgentClient, ScanAgentConfig,
                                         ScanRouter, scanagent_from_dict,
                                         wire)
from horaedb_tpu_torch.scanagent import agent as agent_mod
from horaedb_tpu_torch.scanagent import client as client_mod
from horaedb_tpu_torch.storage.config import (StorageConfig, ThreadsConfig,
                                              from_dict)
from horaedb_tpu_torch.storage.plan import TopKSpec
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import tracing

SEED = 1337
SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])

WHICH_SETS = (("avg",), ("min", "max"), ("count",), ("sum", "avg"),
              ("avg", "max", "last"), ALL_AGGS)


@pytest.fixture(autouse=True)
def parts_route(monkeypatch):
    """The direct-scan control takes the parts route, as routed scans
    do; the JAX package's partial sums stay float32 (its device
    program), as the port's are."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")


@pytest.fixture(scope="module")
def runtimes():
    rt = runtimes_mod.from_config(ThreadsConfig())
    yield rt
    rt.close()


def run(coro):
    return asyncio.run(coro)


def batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)


def wreq(rows, wr=WriteRequest, tr=TimeRange):
    lo = min(r[1] for r in rows)
    hi = max(r[1] for r in rows) + 1
    return wr(batch(rows), tr.new(lo, hi))


def storage_config(fd=from_dict, sc=StorageConfig, rd=ReadableDuration):
    cfg = fd(sc, {"scheduler": {"schedule_interval": "1h",
                                "input_sst_min_num": 2}})
    cfg.manifest.merge_interval = rd.parse("1h")
    cfg.scrub.interval = rd.parse("1h")
    return cfg


async def open_storage(store, runtimes):
    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, store, SCHEMA, 2, storage_config(),
        runtimes=runtimes, device="cpu")


def agg_spec(lo: int, hi: int, bucket_ms: int = 60_000,
             which=("avg", "max", "last"), cls=AggregateSpec):
    return cls(group_col="k", ts_col="ts", value_col="v", range_start=lo,
               bucket_ms=bucket_ms,
               num_buckets=max(1, -(-(hi - lo) // bucket_ms)), which=which)


async def write_segments(s, rng, segments=3, rows_per=150, keys=6,
                         wr=WriteRequest, tr=TimeRange):
    for seg in range(segments):
        rows = [(f"k{rng.randint(0, keys - 1)}",
                 seg * SEGMENT_MS + rng.randrange(0, SEGMENT_MS - 1000, 250),
                 float(rng.randint(0, 10**6))) for _ in range(rows_per)]
        await s.write(wreq(rows, wr, tr))


def clear_caches(s, memo=True):
    s.reader.scan_cache.clear()
    s.reader.encoded_cache.clear()
    if memo:
        s.reader.parts_memo.clear()


def _host(grid) -> np.ndarray:
    return grid.cpu().numpy() if hasattr(grid, "cpu") else np.asarray(grid)


def _assert_same(a, b, ctx=""):
    va, ga = a
    vb, gb = b
    assert np.array_equal(va, vb), f"{ctx}: group values differ"
    assert set(ga) == set(gb), f"{ctx}: agg keys {set(ga)} != {set(gb)}"
    for k in ga:
        assert _host(ga[k]).tobytes() == _host(gb[k]).tobytes(), \
            f"{ctx}: grid {k!r} differs"


def attach_router(s, cfg, client_cls=ScanAgentClient, router_cls=ScanRouter):
    client = client_cls(cfg)
    s.reader.scan_router = router_cls(
        cfg, client, s.root_path, s.schema().user_schema,
        s.schema().num_primary_keys, s.segment_duration_ms)
    return client


async def attach_agent(s, runtimes, agent_store=None, slots=(0,),
                       num_slots=1, **cfg_kw):
    """Start a port AgentService on the CPU (colocated with `s`'s store
    unless `agent_store` overrides) and attach a router for it to `s`.
    Returns (service, client, config)."""
    service = AgentService(agent_store if agent_store is not None
                           else s.store, runtimes=runtimes, device="cpu")
    url = await service.start()
    cfg = ScanAgentConfig(mode="on", num_slots=num_slots,
                          agents=(AgentSpec("a0", url, tuple(slots)),),
                          **cfg_kw)
    return service, attach_router(s, cfg), cfg


def served_count() -> float:
    return client_mod._REQUESTS.labels(agent="a0", outcome="ok").value


def fallback_count(reason: str) -> float:
    return client_mod._FALLBACKS.labels(reason=reason).value


async def agent_off(s, req, spec, top_k=None):
    """The control: detach the router, true-cold direct scan."""
    router, s.reader.scan_router = s.reader.scan_router, None
    try:
        clear_caches(s)
        return await s.scan_aggregate(req, spec, top_k=top_k)
    finally:
        s.reader.scan_router = router


async def agent_on(s, req, spec, top_k=None):
    clear_caches(s)
    return await s.scan_aggregate(req, spec, top_k=top_k)


async def _teardown(s, service, client):
    if client is not None:
        await client.close()
    if service is not None:
        await service.close()
    await s.close()


# ---------------------------------------------------------------------------
# bit identity: agent-served vs direct
# ---------------------------------------------------------------------------


def test_agent_vs_off_bit_identity(runtimes):
    """Overlapping writes (cross-SST duplicate PKs), every aggregate
    set, filters incl. In/range, top-k: the agent serves segments and
    every grid byte-matches the parts-route direct scan."""
    async def go():
        rng = random.Random(SEED)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=200)
            await s.write(wreq([("k0", 100, 7.0), ("k1", 350, 8.0)]))
            await s.write(wreq([("k0", 100, 9.0), ("k2", 600, 1.0)]))
            service, client, _cfg = await attach_agent(s, runtimes)
            preds = (None, F.Eq("k", "k1"), F.In("k", ["k0", "k4"]),
                     F.And((F.Ge("ts", 1000), F.Lt("ts", SEGMENT_MS))),
                     F.Eq("k", "nope"))
            for which in WHICH_SETS:
                for pred in preds:
                    spec = agg_spec(0, 2 * SEGMENT_MS, which=which)
                    req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS),
                                      predicate=pred)
                    before = served_count()
                    routed = await agent_on(s, req, spec)
                    assert served_count() > before, \
                        "agent route did not engage"
                    control = await agent_off(s, req, spec)
                    _assert_same(routed, control, f"{which} {pred}")
            tk = TopKSpec(k=2, by="max")
            spec = agg_spec(0, 2 * SEGMENT_MS, which=("max", "avg"))
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            routed = await agent_on(s, req, spec, top_k=tk)
            control = await agent_off(s, req, spec, top_k=tk)
            _assert_same(routed, control, "top-k")
        finally:
            await _teardown(s, service, client)

    run(go())


def test_routed_plan_skips_the_fused_route(runtimes, monkeypatch):
    """With the fused route forced on, a plan the router covers still
    takes the parts route (router_covers ahead of the fused gate), so
    its grids byte-match the parts-route control."""
    async def go():
        rng = random.Random(SEED + 1)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=120)
            service, client, _cfg = await attach_agent(s, runtimes)
            spec = agg_spec(0, 2 * SEGMENT_MS, which=ALL_AGGS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
            plan = await s.build_scan_plan(req)
            assert s.reader.fused_aggregate_ok(plan)
            assert s.reader.router_covers(plan)
            before = served_count()
            routed = await agent_on(s, req, spec)
            assert served_count() - before == 2
            monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
            _assert_same(routed, await agent_off(s, req, spec), "fused on")
        finally:
            await _teardown(s, service, client)

    run(go())


def test_partial_coverage_routes_only_covered(runtimes):
    """A shard map covering only slot 0 of 2: covered segments route,
    uncovered scan directly, the combined grid still byte-matches."""
    async def go():
        rng = random.Random(SEED + 2)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=4, rows_per=120)
            service, client, _cfg = await attach_agent(
                s, runtimes, slots=(0,), num_slots=2)
            spec = agg_spec(0, 4 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 4 * SEGMENT_MS))
            before = served_count()
            routed = await agent_on(s, req, spec)
            # 4 segments, alternating slots -> exactly 2 agent-served
            assert served_count() - before == 2
            _assert_same(routed, await agent_off(s, req, spec),
                         "partial coverage")
        finally:
            await _teardown(s, service, client)

    run(go())


def test_memo_serves_repeat_routed_query(runtimes):
    """Agent-served partials enter the PartsMemo like local ones: the
    repeat query is memo-served with zero further agent RPCs."""
    async def go():
        rng = random.Random(SEED + 3)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=100)
            service, client, _cfg = await attach_agent(s, runtimes)
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            first = await agent_on(s, req, spec)
            mark = served_count()
            again = await s.scan_aggregate(req, spec)  # caches intact
            assert served_count() == mark, "repeat query hit the agent"
            _assert_same(first, again, "memo repeat")
        finally:
            await _teardown(s, service, client)

    run(go())


# ---------------------------------------------------------------------------
# failure handling: kill / breaker / stale map / oversized / degraded
# ---------------------------------------------------------------------------


def test_agent_killed_mid_gather_falls_back(runtimes):
    """The agent closes while a routed gather is in flight: the query
    completes through the direct-read fallback, byte-identical, and
    the fallback is counted."""
    async def go():
        rng = random.Random(SEED + 4)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=3, rows_per=150)
            # seeded latency at the agent's shard keeps its scans in
            # flight, so the close below lands mid-gather
            service, client, _cfg = await attach_agent(
                s, runtimes, agent_store=FaultInjectingStore(
                    s.store, seed=SEED, latency_range=(0.05, 0.05)))
            spec = agg_spec(0, 3 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
            control = await agent_off(s, req, spec)
            clear_caches(s)
            before = fallback_count("error") + fallback_count("timeout")
            task = asyncio.ensure_future(s.scan_aggregate(req, spec))
            for _ in range(3):
                await asyncio.sleep(0)
            await service.close()
            _assert_same(await task, control, "killed mid-gather")
            assert fallback_count("error") + fallback_count("timeout") \
                > before
        finally:
            await _teardown(s, service, client)

    run(go())


def test_breaker_opens_on_dead_agent(runtimes):
    """Repeated failures open the agent's circuit: later queries skip
    the connect (outcome breaker_open) and still serve correct grids
    through the fallback."""
    async def go():
        rng = random.Random(SEED + 5)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=80)
            service, client, _cfg = await attach_agent(
                s, runtimes, breaker_failures=2)
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            control = await agent_off(s, req, spec)
            await service.close()  # dead from the start
            service = None
            before = fallback_count("breaker_open")
            for _ in range(3):
                _assert_same(await agent_on(s, req, spec), control,
                             "dead agent")
            assert client.breakers["a0"].state != "closed"
            assert fallback_count("breaker_open") > before
        finally:
            await _teardown(s, service, client)

    run(go())


def test_half_open_probe_survives_protocol_refusal(runtimes):
    """A half-open breaker's one probe ending in a protocol answer (413
    oversized) settles the breaker: it closes and keeps answering."""
    async def go():
        rng = random.Random(SEED + 12)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=80)
            service, client, _cfg = await attach_agent(
                s, runtimes, breaker_failures=2,
                breaker_cooldown=ReadableDuration.parse("0s"))
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            control = await agent_off(s, req, spec)
            port = int(service.url.rsplit(":", 1)[1])
            await service.close()
            _assert_same(await agent_on(s, req, spec), control, "dead")
            assert client.breakers["a0"].state != "closed"
            # revive at the SAME port, refusing every partial: the 0 s
            # cooldown admits one probe, the 413 is an answer
            service = AgentService(
                s.store, config=ScanAgentConfig(max_partial_bytes=1),
                runtimes=runtimes, device="cpu")
            await service.start(port=port)
            before = fallback_count("oversized")
            _assert_same(await agent_on(s, req, spec), control, "probe")
            assert fallback_count("oversized") > before
            assert client.breakers["a0"].state == "closed"
            mark = client_mod._REQUESTS.labels(
                agent="a0", outcome="breaker_open").value
            _assert_same(await agent_on(s, req, spec), control, "post")
            assert client_mod._REQUESTS.labels(
                agent="a0", outcome="breaker_open").value == mark
        finally:
            await _teardown(s, service, client)

    run(go())


def test_stale_shard_map_falls_back(runtimes):
    """The map says the agent owns the segments, but its shard store
    has none of the bytes: 409 stale_ssts, and the coordinator serves
    the truth directly."""
    async def go():
        rng = random.Random(SEED + 6)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=80)
            service, client, _cfg = await attach_agent(
                s, runtimes, agent_store=MemoryObjectStore())
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            before = fallback_count("stale")
            routed = await agent_on(s, req, spec)
            _assert_same(routed, await agent_off(s, req, spec), "stale")
            assert fallback_count("stale") > before
        finally:
            await _teardown(s, service, client)

    run(go())


def test_oversized_partial_refused(runtimes):
    """An agent refuses a partial beyond max_partial_bytes (413):
    reason=oversized fallback, identical grids, breaker closed."""
    async def go():
        rng = random.Random(SEED + 7)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=120)
            service, client, _cfg = await attach_agent(
                s, runtimes, max_partial_bytes=64)
            service.config = ScanAgentConfig(max_partial_bytes=64)
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            before = fallback_count("oversized")
            routed = await agent_on(s, req, spec)
            _assert_same(routed, await agent_off(s, req, spec), "oversized")
            assert fallback_count("oversized") > before
            assert client.breakers["a0"].state == "closed"
        finally:
            await _teardown(s, service, client)

    run(go())


def test_degraded_gather_when_fallback_disabled(runtimes):
    """fallback = false and a lost shard: covered segments are DROPPED
    with degraded accounting instead of read directly."""
    async def go():
        rng = random.Random(SEED + 8)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=80)
            service, client, _cfg = await attach_agent(
                s, runtimes, fallback=False)
            await service.close()
            service = None
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            before = client_mod._DEGRADED.value
            values, _grids = await agent_on(s, req, spec)
            assert len(values) == 0, "lost-shard segments must drop"
            assert client_mod._DEGRADED.value - before == 2
        finally:
            await _teardown(s, service, client)

    run(go())


# ---------------------------------------------------------------------------
# protocol edges: deadline, tenant quota, trace stitching
# ---------------------------------------------------------------------------


def test_deadline_expired_at_agent_504(runtimes):
    """An exhausted X-Deadline-Ms answers 504 at the agent, and an
    expired coordinator deadline surfaces DeadlineExceeded — never a
    fallback that burns more time."""
    async def go():
        import aiohttp

        rng = random.Random(SEED + 9)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=1, rows_per=60)
            service, client, _cfg = await attach_agent(s, runtimes)
            spec = agg_spec(0, SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, SEGMENT_MS))
            await agent_on(s, req, spec)  # registers the table
            before = agent_mod._SCANS.labels(outcome="deadline").value
            body = wire.encode_scan_request(
                s.root_path, 0, [], TimeRange.new(0, SEGMENT_MS), None, spec)
            async with aiohttp.ClientSession() as sess:
                async with sess.post(
                        service.url + "/v1/scan", json=body,
                        headers={"X-Deadline-Ms": "0"},
                        timeout=aiohttp.ClientTimeout(total=5)) as resp:
                    assert resp.status == 504
                    assert (await resp.json())["code"] == "deadline"
            assert agent_mod._SCANS.labels(outcome="deadline").value == \
                before + 1
            clear_caches(s)
            with deadline_scope(Deadline.after(0.0, reason="test")):
                with pytest.raises(DeadlineExceeded):
                    await s.scan_aggregate(req, spec)
        finally:
            await _teardown(s, service, client)

    run(go())


def test_tenant_quota_charged_at_agent(runtimes):
    """The scan-byte quota is charged where the bytes are read — at the
    agent — and the breach surfaces as the coordinator's QuotaExceeded
    with the agent's Retry-After, not as a fallback."""
    async def go():
        rng = random.Random(SEED + 10)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=2, rows_per=300)
            agent_tenants = TenantRegistry(tenants_from_dict({
                "enabled": True,
                "tenant": {"t1": {"scan_bytes_per_s": "1KB",
                                  "scan_burst_bytes": "1KB"}}}))
            service = AgentService(s.store, tenants=agent_tenants,
                                   runtimes=runtimes, device="cpu")
            url = await service.start()
            client = attach_router(s, ScanAgentConfig(
                mode="on", agents=(AgentSpec("a0", url, (0,)),)))
            # the coordinator's tenant is unlimited: the breach can only
            # have been charged at the agent
            coord = TenantRegistry(tenants_from_dict({
                "enabled": True, "tenant": {"t1": {}}}))
            spec = agg_spec(0, 2 * SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS))
            clear_caches(s)
            before = agent_mod._SCANS.labels(outcome="quota").value
            with tenant_scope(coord.resolve("t1")):
                with pytest.raises(QuotaExceeded) as exc:
                    await s.scan_aggregate(req, spec)
            assert exc.value.resource == "scan_bytes"
            assert exc.value.tenant == "t1"
            assert exc.value.retry_after_s > 0
            assert agent_mod._SCANS.labels(outcome="quota").value > before
        finally:
            await _teardown(s, service, client)

    run(go())


def test_trace_stitching_agent_under_routing_span(runtimes):
    """The agent adopts the coordinator's trace id and exports its
    spans; the coordinator reparents them under the scanagent_rpc span,
    and the partial bytes are attributed to the trace."""
    async def go():
        rng = random.Random(SEED + 11)
        s = await open_storage(MemoryObjectStore(), runtimes)
        service = client = None
        try:
            await write_segments(s, rng, segments=1, rows_per=60)
            service, client, _cfg = await attach_agent(s, runtimes)
            spec = agg_spec(0, SEGMENT_MS)
            req = ScanRequest(range=TimeRange.new(0, SEGMENT_MS))
            trace = tracing.recorder.start(
                "/query", trace_id=tracing.new_trace_id(), forced=True)
            with tracing.trace_scope(trace):
                clear_caches(s)
                await s.scan_aggregate(req, spec)
            done = tracing.recorder.finish(trace)
            spans = done["spans"]
            rpc_ids = {sp["span_id"] for sp in spans
                       if sp["name"] == "scanagent_rpc"}
            assert rpc_ids, "no scanagent_rpc span recorded"
            roots = [sp for sp in spans if sp["name"] == "scanagent/scan"]
            assert roots, "agent spans were not stitched in"
            assert all(sp["parent_id"] in rpc_ids for sp in roots)
            assert done["counters"].get("scanagent_partial_bytes", 0) > 0
            # the agent's own stage attribution folds into the trace
            assert done["counters"].get("stage_device_aggregate_ms", 0) > 0
            tree = tracing.span_tree(done)["tree"]
            assert tree["name"] == "/query"
        finally:
            await _teardown(s, service, client)

    run(go())


# ---------------------------------------------------------------------------
# wire and config
# ---------------------------------------------------------------------------


def test_wire_predicate_roundtrip():
    preds = [
        None,
        F.Eq("k", "abc"),
        F.Ne("v", 3.5),
        F.In("tsid", np.asarray([1, 5, 2**63], dtype=np.uint64)),
        F.In("k", ["a", "b"]),
        F.And((F.Ge("ts", 100), F.Lt("ts", 10**13))),
        F.Or((F.Eq("k", b"bin"), F.Not(F.Eq("k", "x")))),
        F.TimeRangePred("ts", 0, 2**40),
    ]
    for p in preds:
        back = wire.decode_predicate(wire.encode_predicate(p))
        assert F.canonical_predicate_key(back) == \
            F.canonical_predicate_key(p), p
    back = wire.decode_predicate(wire.encode_predicate(preds[3]))
    assert isinstance(back.values, np.ndarray)
    assert back.values.dtype == np.uint64


def _wire_parts(rng):
    cases = [
        (np.asarray([1, 7, 9], dtype=np.uint64), 3),
        (np.asarray([b"a", b"bb", b"ccc"], dtype=object), 0),
        (np.asarray(["x", "yy"], dtype=object), 2),
        (np.asarray([5, 6], dtype=np.int32), 1),
    ]
    parts = []
    for values, lo in cases:
        g = len(values)
        parts.append((values, lo, {
            "count": rng.integers(0, 5, (g, 4)).astype(np.int32),
            "sum": rng.random((g, 4)).astype(np.float32),
            "avg": rng.random((g, 4)).astype(np.float64),
            "last_ts": rng.integers(0, 10**9, (g, 4)),
        }))
    big = rng.random((4, 8)).astype(np.float32)
    parts.append((np.asarray([1, 2], dtype=np.int64), 0,
                  {"sum": big[:2, :5]}))
    return parts


def test_wire_parts_roundtrip_exact():
    """Values AND dtypes round-trip byte-exactly (non-contiguous grid
    slices included); malformed payloads are refused."""
    parts = _wire_parts(np.random.default_rng(SEED))
    back = wire.decode_parts(wire.encode_parts(parts))
    assert len(back) == len(parts)
    for (va, la, ga), (vb, lb, gb) in zip(parts, back):
        assert la == lb and va.dtype == vb.dtype
        assert list(va) == list(vb)
        assert set(ga) == set(gb)
        for k in ga:
            assert ga[k].dtype == gb[k].dtype, k
            assert np.ascontiguousarray(ga[k]).tobytes() == \
                gb[k].tobytes(), k
    with pytest.raises(Error):
        wire.decode_parts(b"garbage")


def test_wire_bytes_equal_the_reference():
    """The wire is a protocol: the same parts and the same request
    encode to the same bytes in both packages, and each decodes the
    other's."""
    from horaedb_tpu.ops import filter as RF
    from horaedb_tpu.scanagent import wire as rwire
    from horaedb_tpu.storage.read import AggregateSpec as RSpec
    from horaedb_tpu.storage.sst import FileMeta as RMeta
    from horaedb_tpu.storage.sst import SstFile as RSst
    from horaedb_tpu.storage.types import TimeRange as RRange

    from horaedb_tpu_torch.storage.sst import FileMeta, SstFile

    parts = _wire_parts(np.random.default_rng(SEED + 1))
    blob = wire.encode_parts(parts)
    assert blob == rwire.encode_parts(parts)
    for (va, la, ga), (vb, lb, gb) in zip(wire.decode_parts(blob),
                                          rwire.decode_parts(blob)):
        assert la == lb and list(va) == list(vb) and va.dtype == vb.dtype
        assert {k: g.tobytes() for k, g in ga.items()} == \
            {k: g.tobytes() for k, g in gb.items()}

    def request(fl, meta, sst, rng_cls, spec_cls):
        pred = fl.And((fl.In("tsid", np.asarray([3, 2**40], np.uint64)),
                       fl.Or((fl.Eq("k", "a"), fl.Ne("v", 2.5))),
                       fl.TimeRangePred("ts", 0, 10**12)))
        ssts = [sst(7, meta(max_sequence=9, num_rows=100, size=4096,
                            time_range=rng_cls.new(0, 3_600_000))),
                sst(11, meta(max_sequence=12, num_rows=5, size=512,
                             time_range=rng_cls.new(10, 20)))]
        return fl, pred, ssts, rng_cls.new(0, 7_200_000), \
            agg_spec(0, 7_200_000, which=ALL_AGGS, cls=spec_cls)

    ours = request(F, FileMeta, SstFile, TimeRange, AggregateSpec)
    theirs = request(RF, RMeta, RSst, RRange, RSpec)
    body = wire.encode_scan_request("db", 0, ours[2], ours[3], ours[1],
                                    ours[4], projections=[0, 2])
    rbody = rwire.encode_scan_request("db", 0, theirs[2], theirs[3],
                                      theirs[1], theirs[4],
                                      projections=[0, 2])
    assert json.dumps(body) == json.dumps(rbody)
    decoded = wire.decode_scan_request(json.loads(json.dumps(rbody)))
    assert F.canonical_predicate_key(decoded[4]) == \
        RF.canonical_predicate_key(theirs[1])


def test_scanagent_config_from_dict():
    cfg = scanagent_from_dict({
        "mode": "on", "num_slots": 4, "timeout": "2s",
        "max_partial_bytes": 1024, "fallback": False,
        "breaker_failures": 5, "breaker_cooldown": "1s",
        "agents": [{"name": "a0", "url": "http://h0:9201/",
                    "slots": [0, 1]},
                   {"name": "a1", "url": "http://h1:9201", "slots": [2]}],
    })
    assert cfg.active and cfg.timeout.seconds == 2.0
    assert cfg.agents[0].url == "http://h0:9201"
    assert cfg.owner(0, SEGMENT_MS).name == "a0"
    assert cfg.owner(2 * SEGMENT_MS, SEGMENT_MS).name == "a1"
    assert cfg.owner(3 * SEGMENT_MS, SEGMENT_MS) is None
    for bad in ({"mode": "sideways"}, {"bogus_key": 1},
                {"num_slots": 2, "agents": [
                    {"name": "a", "url": "http://x", "slots": [7]}]},
                {"agents": [{"name": "a", "url": "http://x", "slots": [0]},
                            {"name": "a", "url": "http://y",
                             "slots": [0]}]}):
        with pytest.raises(Error):
            scanagent_from_dict(bad)
    assert not scanagent_from_dict({}).active


def test_get_stream_through_middleware():
    """A streamed read passes through the wrappers: a "get" fault rule
    covers get_stream, and the instrumented store counts it."""
    async def drain(stream):
        return b"".join([c async for c in stream])

    async def go():
        import os

        from horaedb_tpu_torch.objstore.middleware import InjectedFault

        inner = MemoryObjectStore()
        data = os.urandom(50_000)
        await inner.put("a/b", data)
        faulty = FaultInjectingStore(inner)
        faulty.fail_next("get", "a/b")
        with pytest.raises(InjectedFault):
            await drain(faulty.get_stream("a/b"))
        assert await drain(faulty.get_stream("a/b")) == data
        metered = InstrumentedStore(FaultInjectingStore(inner))
        before = metered._ops["get_stream"][0].value
        assert await drain(metered.get_stream("a/b")) == data
        assert metered._ops["get_stream"][0].value == before + 1

    run(go())


# ---------------------------------------------------------------------------
# across packages: each coordinator served by the other package's agent
# ---------------------------------------------------------------------------


async def _ref_storage(store, runtimes):
    from horaedb_tpu.common import ReadableDuration as RRd
    from horaedb_tpu.storage.config import StorageConfig as RCfg
    from horaedb_tpu.storage.config import from_dict as rfd
    from horaedb_tpu.storage.storage import CloudObjectStorage as RCos

    return await RCos.open("db", SEGMENT_MS, store, SCHEMA, 2,
                           storage_config(rfd, RCfg, RRd),
                           runtimes=runtimes)


@pytest.mark.parametrize("coordinator", ["port", "reference"])
def test_cross_package_agent_serves_the_other_coordinator(runtimes,
                                                          coordinator):
    """The port's coordinator routed to the JAX package's agent, and the
    JAX package's coordinator routed to the port's: each package's grids
    equal its own direct scan byte for byte."""
    from horaedb_tpu.common import runtimes as rruntimes
    from horaedb_tpu.objstore import MemoryObjectStore as RMem
    from horaedb_tpu.scanagent import AgentService as RAgent
    from horaedb_tpu.scanagent import AgentSpec as RSpecA
    from horaedb_tpu.scanagent import ScanAgentClient as RClient
    from horaedb_tpu.scanagent import ScanAgentConfig as RCfgA
    from horaedb_tpu.scanagent import ScanRouter as RRouter
    from horaedb_tpu.storage.config import ThreadsConfig as RThreads
    from horaedb_tpu.storage.read import AggregateSpec as RAgg
    from horaedb_tpu.storage.read import ScanRequest as RReq
    from horaedb_tpu.storage.storage import WriteRequest as RWr
    from horaedb_tpu.storage.types import TimeRange as RTr

    async def go():
        rrt = rruntimes.from_config(RThreads())
        rng = random.Random(SEED + 21)
        if coordinator == "port":
            s = await open_storage(MemoryObjectStore(), runtimes)
            await write_segments(s, rng, segments=3, rows_per=150)
            service = RAgent(s.store, runtimes=rrt)
            cfg_cls, spec_cls, client_cls, router_cls = (
                ScanAgentConfig, AgentSpec, ScanAgentClient, ScanRouter)
            agg_cls, req_cls, tr = AggregateSpec, ScanRequest, TimeRange
        else:
            s = await _ref_storage(RMem(), rrt)
            await write_segments(s, rng, segments=3, rows_per=150,
                                 wr=RWr, tr=RTr)
            service = AgentService(s.store, runtimes=runtimes, device="cpu")
            cfg_cls, spec_cls, client_cls, router_cls = (
                RCfgA, RSpecA, RClient, RRouter)
            agg_cls, req_cls, tr = RAgg, RReq, RTr
        url = await service.start()
        client = attach_router(s, cfg_cls(
            mode="on", agents=(spec_cls("a0", url, (0,)),)),
            client_cls, router_cls)
        try:
            for which in (("avg", "max", "last"), ALL_AGGS):
                spec = agg_spec(0, 3 * SEGMENT_MS, which=which,
                                cls=agg_cls)
                req = req_cls(range=tr.new(0, 3 * SEGMENT_MS))
                before = _ok_count(coordinator)
                routed = await agent_on(s, req, spec)
                assert _ok_count(coordinator) - before == 3
                _assert_same(routed, await agent_off(s, req, spec),
                             f"{coordinator} coordinator {which}")
        finally:
            await client.close()
            await service.close()
            await s.close()
            rrt.close()

    run(go())


def _ok_count(coordinator: str) -> float:
    if coordinator == "port":
        return served_count()
    from horaedb_tpu.scanagent import client as rclient

    return rclient._REQUESTS.labels(agent="a0", outcome="ok").value


# ---------------------------------------------------------------------------
# seeded chaos: agent-served vs direct under churn
# ---------------------------------------------------------------------------


def _chaos_schedule(i: int, runtimes):
    """One seeded schedule: colocated, slow, stale or half-covered
    agent; writes, compactions, evictions, a compaction racing a
    query, and one mid-gather kill — every query byte-compared with the
    detached-router direct scan."""
    async def go():
        rng = random.Random(SEED + 1000 + i)
        scenario = ("colocated", "slow", "stale", "half")[i % 4]
        store = MemoryObjectStore()
        s = await open_storage(store, runtimes)
        agent_store = store
        if scenario == "slow":
            agent_store = FaultInjectingStore(
                store, seed=SEED + i, latency_range=(0.001, 0.01))
        elif scenario == "stale":
            agent_store = MemoryObjectStore()
        service = AgentService(agent_store, runtimes=runtimes, device="cpu")
        url = await service.start()
        client = attach_router(s, ScanAgentConfig(
            mode="on", num_slots=2 if scenario == "half" else 1,
            agents=(AgentSpec("a0", url, (0,)),),
            timeout=ReadableDuration.parse("5s")))
        killed = False

        async def checked_query(racing=None):
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
            if rng.random() < 0.3:
                by_pool = [a for a in which if a != "last_ts"] + ["count"]
                tk = TopKSpec(k=rng.randint(1, 4), by=rng.choice(by_pool),
                              largest=rng.random() < 0.5)
            clear_caches(s)
            if racing is None:
                routed = await s.scan_aggregate(req, spec, top_k=tk)
            else:
                routed, _ = await asyncio.gather(
                    s.scan_aggregate(req, spec, top_k=tk), racing())
            control = await agent_off(s, req, spec, top_k=tk)
            _assert_same(routed, control,
                         f"schedule {i} ({scenario}) lo={lo} hi={hi} "
                         f"which={which} pred={pred} tk={tk}")

        async def compact_once():
            sched = s.compact_scheduler
            task = await sched.picker.pick_candidate()
            if task is not None:
                await sched.executor.execute(task)

        try:
            await write_segments(s, rng, segments=3, rows_per=100)
            for _op in range(7):
                op = rng.choice(["write", "query", "query", "compact",
                                 "evict", "race", "kill"])
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
                    await checked_query(racing=compact_once)
                elif op == "kill" and not killed:
                    killed = True
                    spec = agg_spec(0, 3 * SEGMENT_MS)
                    req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
                    clear_caches(s)
                    task = asyncio.ensure_future(s.scan_aggregate(req, spec))
                    for _ in range(rng.randint(1, 4)):
                        await asyncio.sleep(0)
                    await service.close()
                    _assert_same(await task, await agent_off(s, req, spec),
                                 f"schedule {i} kill mid-gather")
                else:
                    await checked_query()
            await checked_query()
        finally:
            await client.close()
            await service.close()
            await s.close()

    run(go())


@pytest.mark.parametrize("schedule", range(4))
def test_seeded_scanagent_chaos_fast(runtimes, schedule):
    """One schedule per scenario (colocated, slow, stale, half)."""
    _chaos_schedule(schedule, runtimes)
