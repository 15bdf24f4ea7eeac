"""The port's planes (horaedb_tpu_torch/utils/{metrics,tracing}.py,
common/{deadline,loops,memledger,tenant}.py, objstore/middleware.py,
cluster/breaker.py) held against the JAX package's on the CPU: the same
seeded operations on both packages' objects give the same renders,
exports, clocks' verdicts, ledgers, quota decisions and fault and
backoff schedules.  Every clock is injected or patched, so nothing here
depends on how busy the test worker is; every process-global family is
read as a delta.  The wiring of the planes into the port's WAL and
reader is held here too (the WAL's tenant gate, the reader's scan-byte
charge and ledger accounts, the watchdog arguments of the WAL and
rollup loops)."""

import asyncio
import random
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.cluster.breaker as r_breaker
import horaedb_tpu.common.deadline as r_deadline
import horaedb_tpu.common.loops as r_loops
import horaedb_tpu.common.memledger as r_memledger
import horaedb_tpu.common.tenant as r_tenant
import horaedb_tpu.objstore.middleware as r_middleware
import horaedb_tpu.utils.metrics as r_metrics
import horaedb_tpu.utils.tracing as r_tracing
import horaedb_tpu_torch.cluster.breaker as p_breaker
import horaedb_tpu_torch.common.deadline as p_deadline
import horaedb_tpu_torch.common.loops as p_loops
import horaedb_tpu_torch.common.memledger as p_memledger
import horaedb_tpu_torch.common.tenant as p_tenant
import horaedb_tpu_torch.objstore.middleware as p_middleware
import horaedb_tpu_torch.utils.metrics as p_metrics
import horaedb_tpu_torch.utils.tracing as p_tracing
from horaedb_tpu.objstore import MemoryObjectStore as RMem
from horaedb_tpu_torch.objstore import MemoryObjectStore as PMem

PACKAGES = {
    "ref": SimpleNamespace(metrics=r_metrics, tracing=r_tracing,
                           deadline=r_deadline, loops=r_loops,
                           memledger=r_memledger, tenant=r_tenant,
                           middleware=r_middleware, breaker=r_breaker,
                           Mem=RMem),
    "port": SimpleNamespace(metrics=p_metrics, tracing=p_tracing,
                            deadline=p_deadline, loops=p_loops,
                            memledger=p_memledger, tenant=p_tenant,
                            middleware=p_middleware, breaker=p_breaker,
                            Mem=PMem),
}


class FakeClock:
    """A monotonic, wall and perf clock that moves only when told."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    monotonic = perf_counter = time = __call__

    def advance(self, dt: float) -> None:
        self.t += dt


def both(fn):
    """Run `fn(P)` on each package and return {name: result}."""
    return {name: fn(P) for name, P in PACKAGES.items()}


def assert_same(results: dict):
    assert results["port"] == results["ref"]
    return results["port"]


# ---------------------------------------------------------------------------
# labelled metrics
# ---------------------------------------------------------------------------


def _registry_ops(P, seed: int):
    reg = P.metrics.MetricsRegistry()
    rng = random.Random(seed)
    c = reg.counter("scan_stage_rows_total", "rows entering each stage")
    g = reg.gauge("scan_cache_bytes", "resident cache bytes by tier")
    h = reg.histogram("scan_stage_seconds", "stage seconds")
    w = reg.histogram("flush_seconds", "flushes", P.metrics.WIDE_BUCKETS)
    bare = reg.counter("storage_rows_scanned_total", "rows")
    for _ in range(200):
        op = rng.randrange(7)
        stage = rng.choice(["fetch", "decode", "device", 'q"u\\o\nte'])
        if op == 0:
            c.labels(stage=stage).inc(rng.randint(1, 1000))
        elif op == 1:
            g.labels(tier=rng.choice(["hbm", "tier2"])).set(
                rng.randint(0, 10**9))
        elif op == 2:
            h.labels(stage=stage).observe(rng.random() * 3)
        elif op == 3:
            w.observe(rng.random() * 700)
        elif op == 4:
            bare.inc()
        elif op == 5:
            g.labels(tier="hbm").dec(rng.randint(0, 5))
        else:
            c.remove(stage=rng.choice(["fetch", "decode"]))
    return reg.render(), reg.samples(), c.total


def test_registry_render_matches_the_reference_byte_for_byte():
    """The same seeded operations on both packages' registries render
    the same Prometheus text, byte for byte, and the same samples."""
    for seed in (1, 2, 3):
        render, samples, total = assert_same(
            both(lambda P: _registry_ops(P, seed)))
        assert 'scan_stage_rows_total{stage="fetch"}' in render \
            or 'stage="decode"' in render
        assert total > 0 and samples


def test_snapshot_keys_series_by_their_rendered_names():
    """The port's snapshot() (a port-only reader for diffs) keys every
    series by the name it renders under; a histogram reads its sum."""
    reg = p_metrics.MetricsRegistry()
    reg.counter("a_total").labels(tier="tier2").inc(3)
    reg.histogram("b_seconds").labels(stage="fetch").observe(0.5)
    reg.gauge("c").set(2)
    snap = reg.snapshot()
    assert snap == {'a_total{tier="tier2"}': 3.0,
                    'b_seconds{stage="fetch"}': 0.5, "c": 2}


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------


def _trace_run(P, monkeypatch):
    clock = FakeClock(1_700_000_000.0)
    monkeypatch.setattr(P.tracing, "time", clock)
    monkeypatch.setattr(P.tracing, "_id_rng", random.Random(42))
    rec = P.tracing.TraceRecorder()
    trace = rec.start("/query", forced=True)
    with P.tracing.trace_scope(trace):
        with P.tracing.span("scan", metric="cpu"):
            clock.advance(0.25)
            P.tracing.trace_add("objstore_get_bytes", 4096)
            with P.tracing.span("scanagent_rpc", agent="a0", segment=0):
                clock.advance(0.5)
                remote = {"spans": [
                    {"span_id": "r1", "parent_id": "", "name": "agent",
                     "start_ms": 1.0, "duration_ms": 2.0, "status": "ok",
                     "fields": {}},
                    {"span_id": "r2", "parent_id": "r1", "name": "decode",
                     "start_ms": 1.5, "duration_ms": 1.0, "status": "ok",
                     "fields": {"rows": 7}},
                    "not a span"],
                    "counters": {"stage_fetch_ms": 3.5, "bad": "x"}}
                P.tracing.ingest_export(
                    P.tracing.json.dumps(remote))
        with pytest.raises(ValueError):
            with P.tracing.span("combine"):
                clock.advance(0.125)
                raise ValueError("boom")
    done = rec.finish(trace)
    big = dict(done, spans=done["spans"] * 60)
    return (done, P.tracing.export_payload(done),
            P.tracing.export_payload(big, limit=2000),
            P.tracing.span_tree(done), P.tracing.summarize(done),
            rec.list())


def test_trace_export_and_stitching_match_the_reference(monkeypatch):
    """With a seeded id source and a fixed clock, a trace's spans,
    export payloads (whole and size-capped), span tree and summary
    equal the reference's, and import_remote stitches a peer's spans
    under the same parent."""
    done, export, capped, tree, summary, listed = assert_same(
        both(lambda P: _trace_run(P, monkeypatch)))
    rpc = next(s for s in done["spans"] if s["name"] == "scanagent_rpc")
    stitched = {s["name"]: s for s in done["spans"]}
    assert stitched["agent"]["parent_id"] == rpc["span_id"]
    assert stitched["decode"]["parent_id"] == "r1"
    assert done["counters"] == {"objstore_get_bytes": 4096,
                                "stage_fetch_ms": 3.5}
    assert stitched["combine"]["status"] == "error"
    assert len(capped) <= 2000 and '"dropped_spans"' in capped
    assert tree["tree"]["name"] == "/query" and summary.startswith("total=")
    assert listed[0]["spans"] == len(done["spans"])


def test_op_trace_records_in_the_op_ring_or_as_a_span(monkeypatch):
    """op_trace opens its own kind="op" trace outside a request and
    records as a span of the ambient trace inside one — the same in
    both packages."""
    def go(P):
        monkeypatch.setattr(P.tracing, "recorder", P.tracing.TraceRecorder())
        monkeypatch.setattr(P.tracing, "_id_rng", random.Random(7))
        with P.tracing.op_trace("flush", slow_s=60.0, segment=3) as tr:
            P.tracing.trace_add("rows", 5)
        op = P.tracing.recorder.list(kind="op")
        outer = P.tracing.recorder.start("/q", forced=True)
        with P.tracing.trace_scope(outer):
            with P.tracing.op_trace("flush") as inner:
                assert inner is None
        d = P.tracing.recorder.finish(outer)
        return (tr.kind, tr.counters, [(o["root"], o["kind"]) for o in op],
                [s["name"] for s in d["spans"]])

    assert assert_same(both(go))[2] == [("flush", "op")]


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def _deadline_run(P, monkeypatch):
    clock = FakeClock(50.0)
    monkeypatch.setattr(P.deadline, "time", clock)
    out = []
    dl = P.deadline.Deadline.after(5.0, reason="query")
    unbounded = P.deadline.Deadline.after(None)
    for dt in (0.0, 1.5, 2.0, 1.4999, 0.0001, 3.0):
        clock.advance(dt)
        try:
            dl.check()
            ok = "ok"
        except P.deadline.DeadlineExceeded as e:
            ok = str(e)
        with P.deadline.deadline_scope(dl):
            out.append((dl.remaining(), dl.budget(1.0), dl.budget(None),
                        dl.expired, ok,
                        P.deadline.remaining_budget(2.0)))
    out.append((unbounded.remaining(), unbounded.budget(3.0),
                unbounded.expired, P.deadline.remaining_budget(4.0)))
    tok = P.deadline.Deadline.after(10.0)
    tok.cancel()
    with P.deadline.deadline_scope(tok):
        with pytest.raises(P.deadline.DeadlineExceeded, match="cancelled"):
            P.deadline.checkpoint()
    return out


def test_deadline_remaining_budget_and_checkpoint_match(monkeypatch):
    out = assert_same(both(lambda P: _deadline_run(P, monkeypatch)))
    assert out[0][0] == 5.0 and out[-2][4].endswith("deadline exceeded")


# ---------------------------------------------------------------------------
# the loop watchdog
# ---------------------------------------------------------------------------


def _watchdog_run(P):
    clock = FakeClock(0.0)
    reg = P.loops.LoopRegistry(clock=clock)
    reg.configure(stall_factor=4.0, min_stall_s=5.0)
    hs = {
        "busy": reg.register("wal-commit:/a", stall_threshold_s=30.0),
        "periodic": reg.register("wal-flusher:/a", period_s=2.0),
        "default": reg.register("compact-picker:/a"),
        "idle": reg.register("rollup:/a", period_s=1.0),
        "dup": reg.register("wal-commit:/a", stall_threshold_s=30.0),
    }
    schedule = []
    for step in range(40):
        clock.advance(1.0)
        if step % 3 == 0:
            hs["periodic"].beat()
        if step == 2:
            hs["idle"].idle()
        if step in (12, 13):
            hs["default"].beat()
        if step == 25:
            hs["busy"].beat()
            hs["busy"].error(RuntimeError("fsync failed"))
        schedule.append(reg.check_once())
    snap = [{k: v for k, v in d.items() if k != "backlog"}
            for d in reg.snapshot()]
    return schedule, snap, reg.summary(), sorted(h.name for h in
                                                 reg.handles())


def test_watchdog_fires_on_the_same_fake_clock_schedule():
    """A fake clock, the same beats: the watchdog flags the same loops
    at the same sweeps (once per episode), and its snapshot and summary
    agree with the reference's."""
    schedule, snap, summary, names = assert_same(both(_watchdog_run))
    fired = [(i, n) for i, names_i in enumerate(schedule) for n in names_i]
    assert (4, "compact-picker:/a") in fired  # 5 s default threshold
    assert (29, "wal-commit:/a#2") in fired  # 30 s declared floor
    assert "wal-commit:/a#2" in names
    assert summary["erroring"] == ["wal-commit:/a"]


def test_wal_and_rollup_loops_carry_the_watchdog_arguments(tmp_path):
    """The WAL's commit and flush loops and the rollup loop register
    with the reference's kinds, thresholds and backlog hints."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.rollup import RollupConfig
    from horaedb_tpu_torch.wal import WalConfig

    async def go():
        e = await MetricEngine.open(
            "db", PMem(), device="cpu",
            wal_config=WalConfig(enabled=True, dir=str(tmp_path / "wal")),
            rollup_config=RollupConfig(enabled=True, specs=["cpu"]))
        try:
            snap = {d["name"]: d for d in p_loops.loops.snapshot()}
            commit = snap[f"wal-commit:{tmp_path}/wal/data"]
            flusher = snap[f"wal-flusher:{tmp_path}/wal/data"]
            rollup = snap["rollup:db"]
            return commit, flusher, rollup
        finally:
            await e.close()

    commit, flusher, rollup = asyncio.run(go())
    assert commit["kind"] == "wal-commit" and commit["owner"] == "wal"
    assert commit["stall_threshold_s"] == 30.0
    assert set(commit["backlog"]) == {"queued_records", "queued_bytes",
                                      "backlog_bytes"}
    assert flusher["kind"] == "wal-flusher"
    assert flusher["stall_threshold_s"] >= 300.0
    assert set(flusher["backlog"]) == {"memtable_rows", "memtable_bytes",
                                       "wal_backlog_bytes"}
    assert rollup["kind"] == "rollup" and rollup["stall_threshold_s"] >= 600
    assert rollup["backlog"]["specs"] == 1


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------


class _Owner:
    def __init__(self, n: int):
        self.n = n


def _ledger_run(P):
    clock = FakeClock(0.0)
    led = P.memledger.MemoryLedger(clock=clock, rss_reader=lambda: 10_000)
    led.configure(soft_bytes=6_000, hard_bytes=9_000, interval_s=5.0)
    owners = [_Owner(1000 * (i + 1)) for i in range(3)]
    accts = [led.register(f"scan_cache:/t{i}", lambda o: o.n, anchor=o,
                          budget=4000) for i, o in enumerate(owners)]
    led.register("stack_cache:/t0", lambda o: 2 * o.n, anchor=owners[0],
                 host=False)
    flow = led.flow("scanagent_wire")
    flow.charge(700)
    flow.charge(300)
    flow.credit(600)
    out = [led.summary()]
    del owners[1]  # a dropped owner prunes on the next sweep
    led.deregister(accts[2])
    clock.advance(20.0)
    out.append(led.summary())
    out.append(led.sample_once(rss=5_000)["pressure"])
    out.append(sorted(led.kinds()))
    tree = led.snapshot()
    out.append({k: (g["bytes"], g["budget"], g["high_water"], g["host"])
                for k, g in tree["accounts"].items()})
    out.append((tree["attributed_bytes"], tree["unattributed_bytes"],
                tree["pressure"]["episodes"]))
    return out


def test_ledger_summary_matches_for_the_same_accounts():
    """Pull accounts (weakly anchored, a dead owner pruned), a device
    account kept out of the host total, a flow account: the ledger's
    summary, pressure and account tree agree with the reference's."""
    out = assert_same(both(_ledger_run))
    first = out[0]
    assert first["accounts"] == {"scan_cache": 6000, "stack_cache": 2000,
                                 "scanagent_wire": 400}
    assert first["attributed_bytes"] == 6400
    assert first["unattributed_bytes"] == 3600
    assert first["pressure"] == 2
    assert out[1]["accounts"] == {"scan_cache": 1000, "stack_cache": 2000,
                                  "scanagent_wire": 400}


def test_device_memory_reads_cuda_or_nothing(monkeypatch):
    """The port's device side reads torch's allocator per CUDA device;
    with no card (or no CUDA context) it reports nothing."""
    import torch

    assert p_memledger.device_memory() == [] or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 4096})
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 8192)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(total_memory=80 << 30))
    assert p_memledger.device_memory() == [{
        "device": "cuda:0", "bytes_in_use": 4096,
        "bytes_limit": 80 << 30, "peak_bytes_in_use": 8192}]


def test_reader_and_wal_accounts_register_and_clear(tmp_path):
    """The port's accounts sit where the reference's do: a WAL-fronted
    engine registers its reader tiers, memtables and WAL backlog, and
    close() deregisters them."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.scanagent import client  # noqa: F401
    from horaedb_tpu_torch.wal import WalConfig

    led = p_memledger.ledger
    root = str(tmp_path / "acct")

    def mine():
        return {a.kind for a in led.accounts()
                if root in a.name or root in a.owner}

    async def go():
        e = await MetricEngine.open(
            root, PMem(), device="cpu",
            wal_config=WalConfig(enabled=True, dir=str(tmp_path / "wal")))
        try:
            kinds = mine() | {a.kind for a in led.accounts()
                              if str(tmp_path / "wal") in a.name}
        finally:
            await e.close()
        return kinds, mine()

    opened, closed = asyncio.run(go())
    assert {"scan_cache", "stack_cache", "encoded_cache", "parts_memo",
            "memtable", "wal_backlog"} <= opened
    assert closed == set()
    assert {"pipeline_inflight", "streamed_mmap",
            "scanagent_wire"} <= led.kinds()


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------


def _tenant_run(P):
    clock = FakeClock(0.0)
    reg = P.tenant.TenantRegistry(P.tenant.tenants_from_dict({
        "enabled": True,
        "default": {"wal_bytes_per_s": "1KB"},
        "tenant": {"t1": {"scan_bytes_per_s": "2KB",
                          "scan_burst_bytes": "4KB",
                          "wal_bytes_per_s": "512B",
                          "wal_burst_bytes": "1KB"}},
    }), clock=clock)
    t1, dflt = reg.resolve("t1"), reg.resolve("nobody")
    rng = random.Random(9)
    out = [dflt.name]
    for _ in range(60):
        clock.advance(rng.choice([0.0, 0.1, 0.5, 1.0]))
        who = rng.choice([t1, dflt])
        nbytes = rng.choice([100, 400, 900, 3000])
        if rng.random() < 0.5:
            try:
                who.admit_wal(nbytes)
                out.append(("wal", who.name, "ok"))
            except P.tenant.QuotaExceeded as e:
                out.append(("wal", e.tenant, e.resource,
                            round(e.retry_after_s, 9)))
        else:
            who.charge_scan_bytes(nbytes)
            try:
                who.check_scan_budget()
                out.append(("scan", who.name, "ok"))
            except P.tenant.QuotaExceeded as e:
                out.append(("scan", e.tenant, e.resource,
                            round(e.retry_after_s, 9)))
    with pytest.raises(P.tenant.Error):
        reg.resolve("bad name!")
    return out


def test_tenant_buckets_give_the_same_admits_and_retry_after():
    """Seeded WAL admits and scan charges under a fake clock: the same
    admissions, the same denials, the same Retry-After in both."""
    out = assert_same(both(_tenant_run))
    assert out[0] == "default"
    kinds = {o[2] for o in out[1:]}
    assert {"ok", "wal_rate", "scan_bytes"} <= kinds


def test_wal_tenant_gate_rejects_before_the_group_commit(tmp_path):
    """The WAL's admit_wal gate runs ahead of the group commit: a
    flooding tenant's write raises QuotaExceeded and costs no WAL
    frame, as in the reference."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.wal import WalConfig

    reg = p_tenant.TenantRegistry(p_tenant.tenants_from_dict({
        "enabled": True,
        "tenant": {"t1": {"wal_bytes_per_s": "1KB",
                          "wal_burst_bytes": "1KB"}}}),
        clock=FakeClock(0.0))
    schema = pa.schema([("host", pa.string()), ("timestamp", pa.int64()),
                        ("value", pa.float64())])

    def rows(n):
        return pa.record_batch(
            [pa.array([f"h{i % 3}" for i in range(n)]),
             pa.array(np.arange(n, dtype=np.int64) * 1000 + 1),
             pa.array(np.ones(n))], schema=schema)

    async def go():
        e = await MetricEngine.open(
            "db", PMem(), device="cpu",
            wal_config=WalConfig(enabled=True, dir=str(tmp_path / "wal")))
        try:
            data = e.tables["data"]
            frames = data.wal._m_appends.value
            with p_tenant.tenant_scope(reg.resolve("t1")):
                await e.write_arrow("cpu", ["host"], rows(4))
                with pytest.raises(p_tenant.QuotaExceeded) as exc:
                    await e.write_arrow("cpu", ["host"], rows(400))
            assert exc.value.resource == "wal_rate"
            assert exc.value.retry_after_s > 0
            return data.wal._m_appends.value - frames
        finally:
            await e.close()

    assert asyncio.run(go()) == 1


def test_reader_charges_scan_bytes_to_the_ambient_tenant():
    """The reader charges the bytes its segment reads attribute to the
    ambient tenant; a bucket in deficit surfaces at the next deadline
    checkpoint as QuotaExceeded."""
    from horaedb_tpu_torch.common import runtimes as runtimes_mod
    from horaedb_tpu_torch.storage.config import ThreadsConfig
    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.storage import (CloudObjectStorage,
                                                   WriteRequest)
    from horaedb_tpu_torch.storage.types import TimeRange

    schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])
    reg = p_tenant.TenantRegistry(p_tenant.tenants_from_dict({
        "enabled": True,
        "tenant": {"t1": {}, "t2": {"scan_bytes_per_s": "1KB",
                                    "scan_burst_bytes": "1KB"}}}),
        clock=FakeClock(0.0))

    async def go():
        rt = runtimes_mod.from_config(ThreadsConfig())
        s = await CloudObjectStorage.open("db", 3_600_000, PMem(), schema,
                                          2, runtimes=rt, device="cpu")
        try:
            for seg in range(3):
                ts = np.arange(500, dtype=np.int64) * 1000 + seg * 3_600_000
                await s.write(WriteRequest(pa.record_batch(
                    [pa.array([f"k{i % 4}" for i in range(500)]),
                     pa.array(ts), pa.array(np.ones(500))], schema=schema),
                    TimeRange.new(int(ts[0]), int(ts[-1]) + 1)))
            spec = AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                                 range_start=0, bucket_ms=60_000,
                                 num_buckets=180, which=("avg",))
            req = ScanRequest(range=TimeRange.new(0, 3 * 3_600_000))
            t1 = reg.resolve("t1")
            before = t1._scan_bytes.value
            with p_tenant.tenant_scope(t1):
                await s.scan_aggregate(req, spec)
            charged = t1._scan_bytes.value - before
            s.reader.scan_cache.clear()
            s.reader.encoded_cache.clear()
            s.reader.parts_memo.clear()
            with p_tenant.tenant_scope(reg.resolve("t2")):
                with pytest.raises(p_tenant.QuotaExceeded):
                    await s.scan_aggregate(req, spec)
            return charged
        finally:
            await s.close()
            rt.close()

    assert asyncio.run(go()) > 0


# ---------------------------------------------------------------------------
# store middleware and the breaker
# ---------------------------------------------------------------------------


class _RecordingAsyncio:
    """The middleware module's view of asyncio: its sleeps are recorded
    and only yield; everything else is the real module."""

    def __init__(self, slept: list):
        self.slept = slept

    def __getattr__(self, name):
        return getattr(asyncio, name)

    async def sleep(self, d, *_a):
        self.slept.append(round(d, 12))
        await asyncio.sleep(0)


def _fault_run(P, monkeypatch):
    slept = []
    monkeypatch.setattr(P.middleware, "asyncio", _RecordingAsyncio(slept))

    async def go():
        store = P.middleware.FaultInjectingStore(
            P.Mem(), seed=17, fault_rate=0.3, latency_range=(0.01, 0.04))
        store.fail_next("get", "b/", times=2)
        store.fail_next("put", "c/", after=True)
        out = []
        for i in range(40):
            op = ("put", "get", "delete", "list")[i % 4]
            path = f"{'abc'[i % 3]}/{i // 4}"
            try:
                if op == "put":
                    await store.put(path, b"x" * i)
                elif op == "get":
                    await store.get(f"{'abc'[i % 3]}/{i // 4 - 1}")
                elif op == "delete":
                    await store.delete(f"a/{i}")
                else:
                    await store.list("")
                out.append((op, "ok"))
            except Exception as e:  # noqa: BLE001 — the outcome is the data
                out.append((op, type(e).__name__, str(e)))
        return out, store.ops_seen

    return asyncio.run(go()), slept


def test_fault_injecting_store_gives_the_same_seeded_sequence(monkeypatch):
    """The same seed gives the same faults (before/after), the same
    scripted firings and the same injected latencies."""
    (out, ops), slept = assert_same(
        both(lambda P: _fault_run(P, monkeypatch)))
    assert ops == 40 and len(slept) == 40
    assert all(0.01 <= d <= 0.04 for d in slept)
    assert any(o[1] == "InjectedFault" for o in out)


def _retry_run(P, monkeypatch):
    slept = []
    monkeypatch.setattr(P.middleware, "asyncio", _RecordingAsyncio(slept))

    async def go():
        inner = P.middleware.FaultInjectingStore(P.Mem())
        store = P.middleware.RetryingObjectStore(
            inner, P.middleware.RetryPolicy(max_retries=3,
                                            base_backoff_s=0.05,
                                            max_backoff_s=0.3, budget=5.0,
                                            budget_refill_per_s=0.0),
            rng=random.Random(5))
        out = []
        await inner.put("m/1", b"v")
        for times in (1, 3, 4, 2, 2):
            inner.fail_next("get", "m/1", times=times)
            try:
                out.append(await store.get("m/1"))
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__)
            inner.clear_faults()
        try:
            await store.get("missing")
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
        return out

    return asyncio.run(go()), slept


def test_retrying_store_backoff_schedule_matches(monkeypatch):
    """Seeded jitter, a bounded retry budget: the same retries, the same
    backoff sleeps, the same give-ups; NotFound is never retried."""
    out, slept = assert_same(both(lambda P: _retry_run(P, monkeypatch)))
    assert out[0] == b"v" and out[-1] == "NotFoundError"
    assert "InjectedFault" in out
    assert slept and all(0.05 <= d <= 0.6 for d in slept)


def _breaker_run(P):
    clock = FakeClock(0.0)
    cfg = P.breaker.BreakerConfig(failure_threshold=3)
    br = P.breaker.CircuitBreaker("agent:a0", cfg, clock=clock)
    out = []
    for step, ev in enumerate("ffsfffaaaprfffapfaaps"):
        clock.advance(0.7 if ev == "a" else 0.1)
        if ev == "f":
            br.record_failure()
        elif ev == "s":
            br.record_success()
        elif ev == "a":
            out.append(("allow", br.allow()))
        elif ev == "p":
            br.abort_probe()
        elif ev == "r":
            clock.advance(60.0)
        out.append((step, br.state))
    return out


def test_breaker_transitions_match_under_an_injected_clock():
    out = assert_same(both(_breaker_run))
    assert ("allow", False) in out and any(s == "open" for _i, s in
                                           [o for o in out
                                            if o[0] != "allow"])


def test_manifest_rides_the_retry_layer():
    """The manifest plane reads and writes through RetryingObjectStore:
    a transient manifest write failure is retried, so the write that
    caused it is acknowledged."""
    from horaedb_tpu_torch.storage.storage import (CloudObjectStorage,
                                                   WriteRequest)
    from horaedb_tpu_torch.storage.types import TimeRange

    schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])

    async def go():
        store = p_middleware.FaultInjectingStore(PMem())
        s = await CloudObjectStorage.open("db", 3_600_000, store, schema, 2,
                                          device="cpu")
        try:
            assert isinstance(s.manifest.store,
                              p_middleware.RetryingObjectStore)
            store.fail_next("put", "manifest/delta")
            await s.write(WriteRequest(pa.record_batch(
                [pa.array(["a"]), pa.array([5], type=pa.int64()),
                 pa.array([1.0])], schema=schema), TimeRange.new(5, 6)))
            assert not store._rules, "the manifest fault never fired"
            return len(await s.manifest.all_ssts())
        finally:
            await s.close()

    assert asyncio.run(go()) == 1


# ---------------------------------------------------------------------------
# Arrow IPC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "zstd", "lz4"])
def test_ipc_stream_and_downsample_tables_match_the_reference(compression):
    """common/ipc.py gives the reference's stream bytes for the same
    table, and a downsample result round-trips through either package's
    Arrow encoding to the same grids."""
    import horaedb_tpu.common.ipc as r_ipc
    import horaedb_tpu_torch.common.ipc as p_ipc

    rng = np.random.default_rng(3)
    grid = rng.random((4, 6))
    grid[1, 2] = np.nan
    out = {"tsids": [9, 3, 2**63 + 1, 7], "num_buckets": 6,
           "aggs": {"avg": grid, "count": np.arange(24.0).reshape(4, 6)}}
    tables = both(lambda P: (r_ipc if P is PACKAGES["ref"]
                             else p_ipc).downsample_to_arrow(out))
    assert tables["port"].schema.equals(tables["ref"].schema,
                                        check_metadata=True)
    assert p_ipc.serialize_stream(tables["port"]) == \
        r_ipc.serialize_stream(tables["ref"])
    blob = p_ipc.serialize_stream(tables["port"], compression)
    back = p_ipc.downsample_from_arrow(
        pa.ipc.open_stream(blob).read_all())
    assert back["tsids"] == out["tsids"] and back["num_buckets"] == 6
    for k, g in out["aggs"].items():
        assert back["aggs"][k].tobytes() == g.tobytes()
    with pytest.raises(ValueError):
        p_ipc.serialize_stream(tables["port"], "snappy")
