"""HTTP server (ref: src/server/src/main.rs).

Endpoints (reference parity + the query surface the reference lacks —
main.rs:59-80 notes "No query/read endpoint exists yet"):

  GET  /         hello
  GET  /toggle   pause/resume the test write-load generator
  GET  /compact  trigger compaction on every table
  GET  /metrics  Prometheus text metrics
  GET  /stats    rows/bytes per table (cluster load signal)
  POST /write    JSON samples: {"samples": [{"name", "labels": {k:v},
                 "timestamp", "value"}]}
  POST /query    JSON: {"metric", "filters": {k:v}, "start", "end",
                 optional "bucket_ms" -> downsample grid}
  GET  /label_values?metric=...&key=...&start=...&end=...
  GET  /label_names?metric=...&start=...&end=...
  GET  /metrics_list?start=...&end=...
  POST /query_arrow   like /query (raw rows) but responds Arrow IPC
  POST /write_arrow?metric=..&tags=a,b  body = Arrow IPC stream

plus /query_topk, /query_multi, the /admin/* routes, /debug/{traces,
tasks,memory} and the replication plane's /repl/* routes.  The engine
runs on the card ("cuda") unless `--device cpu` is given; the request
handlers only ever see numpy grids and Arrow tables, never a device
tensor.  GET /debug/device serves the device profiler
(common/deviceprof.py: per-seam calls, kernel launches, dispatch and
device seconds, transfers, the mesh round timeline) and /stats its
summary; [deviceprof] configures it.  `kind = "S3Like"` serves the
engine from an S3-compatible endpoint (objstore/s3.py) behind the same
per-op store metrics.

Run: python -m horaedb_tpu_torch.server --config docs/example.toml
     [--device cuda]
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import math
import random
import signal
import time
from collections import deque
from typing import Optional

from aiohttp import web

from horaedb_tpu_torch.common import Error, ensure, now_ms
from horaedb_tpu_torch.common.deviceprof import profiler as deviceprof
from horaedb_tpu_torch.common.ipc import host_downsample
from horaedb_tpu_torch.common.deadline import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.common.tenant import (
    QuotaExceeded,
    TenantRegistry,
    current_tenant,
    tenant_scope,
    tenants_from_dict,
)
from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
from horaedb_tpu_torch.objstore import LocalObjectStore
from horaedb_tpu_torch.server.config import (AdmissionConfig, ServerConfig,
                                       load_config)
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import registry, span
from horaedb_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

# endpoints under query admission control + the query deadline; writes
# get the write deadline (and, tenants enabled, the per-tenant WAL rate
# gate) but are never queue-shed (back-pressure belongs to the storage
# write path), admin/ops endpoints run unbounded.  EVERY registered
# route must appear in exactly one of these three sets (the server's
# tests check every route against them), so no endpoint can silently
# bypass the admission+tenant middleware chain.
_QUERY_ENDPOINTS = frozenset({
    "/query", "/query_arrow", "/query_topk", "/query_multi",
    "/label_values", "/label_names", "/metrics_list"})
_WRITE_ENDPOINTS = frozenset({"/write", "/write_arrow"})
_UNGOVERNED_ENDPOINTS = frozenset({
    "/", "/toggle", "/compact", "/metrics", "/stats",
    "/admin/scrub", "/admin/flush", "/admin/rollups",
    "/admin/tenants", "/admin/rebalance",
    "/debug/traces", "/debug/traces/{trace_id}", "/debug/tasks",
    "/debug/memory", "/debug/device",
    # replication ops plane (cluster/replication.py): internal
    # node-to-node shipping — the follower bounds its RPCs client-side,
    # so replication never sheds under query admission pressure
    "/repl/wal/segments", "/repl/wal/read", "/repl/wal/ack",
    "/repl/status"})

_SHED = registry.counter(
    "server_queries_shed_total",
    "queries rejected with 429 because the admission queue was full")
_QUEUE_TIMEOUTS = registry.counter(
    "server_queries_queue_timeout_total",
    "queries rejected with 503 after timing out in the admission queue")
_DEADLINE_504 = registry.counter(
    "server_requests_timed_out_total",
    "requests that exceeded their deadline and returned 504")
_ACTIVE_QUERIES = registry.gauge(
    "server_active_queries", "queries currently executing")
_QUEUED_QUERIES = registry.gauge(
    "server_queued_queries", "queries waiting for an admission slot")


class _ServiceRate:
    """Observed admission service rate: completions per second over a
    sliding window.  The denominator of the load-aware Retry-After —
    backoff guidance derived from queue depth / this rate tracks how
    overloaded the server actually is, where a constant hint tells a
    client to come back into the same collapse."""

    WINDOW_S = 30.0

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._done: deque[float] = deque()

    def _prune(self, now: float) -> None:
        while self._done and now - self._done[0] > self.WINDOW_S:
            self._done.popleft()

    def record(self) -> None:
        now = self._clock()
        self._done.append(now)
        self._prune(now)

    def per_second(self) -> Optional[float]:
        now = self._clock()
        self._prune(now)
        if len(self._done) < 2:
            return None
        dt = now - self._done[0]
        return len(self._done) / dt if dt > 0 else None


def _load_aware_retry_after(cfg: AdmissionConfig, queued: int,
                            rate: Optional[float]) -> str:
    """Retry-After seconds for a 429/503: the estimated time to drain
    the queue ahead of a retry ((queued+1) / observed service rate),
    floored at [admission] retry_after and capped at max_retry_after.
    Falls back to the floor before any completion has been observed."""
    floor = max(1, math.ceil(cfg.retry_after.seconds))
    cap = max(floor, math.ceil(cfg.max_retry_after.seconds or 60.0))
    if not rate or rate <= 0:
        return str(floor)
    eta = (queued + 1) / rate
    return str(min(cap, max(floor, math.ceil(eta))))


class AdmissionController:
    """Semaphore-bounded query pool with a bounded FIFO wait queue
    (docs/robustness.md).  `acquire` returns "ok" (slot held — caller
    must release), "shed" (queue full: answer 429 immediately), or
    "timeout" (waited out `queue_timeout`: answer 503).  Shedding fast
    keeps latency bounded for the queries that ARE admitted instead of
    letting everyone collapse together.  This is the GLOBAL controller
    ([tenants] disabled — the pre-tenant behavior, unchanged);
    FairAdmissionController is the weighted-fair per-tenant upgrade."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self._active = 0
        self._waiters: deque[asyncio.Future] = deque()
        self.rate = _ServiceRate()

    @property
    def active(self) -> int:
        return self._active

    @property
    def queued(self) -> int:
        return len(self._waiters)

    def _wake(self) -> None:
        while (self._waiters
               and self._active < self.config.max_concurrent_queries):
            fut = self._waiters.popleft()
            if not fut.done():  # skip cancelled (timed-out) waiters
                self._active += 1
                _ACTIVE_QUERIES.set(self._active)
                fut.set_result(True)

    async def acquire(self, timeout_s: Optional[float]) -> str:
        if self._active < self.config.max_concurrent_queries:
            self._active += 1
            _ACTIVE_QUERIES.set(self._active)
            return "ok"
        if len(self._waiters) >= self.config.max_queued:
            return "shed"
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        _QUEUED_QUERIES.set(len(self._waiters))
        try:
            await asyncio.wait_for(fut, timeout_s)
            return "ok"
        except asyncio.TimeoutError:
            self._give_back_racing_grant(fut)
            return "timeout"
        except asyncio.CancelledError:
            # client disconnected while queued; a grant that raced the
            # cancellation must be returned or _active ratchets up
            self._give_back_racing_grant(fut)
            raise
        finally:
            try:
                self._waiters.remove(fut)
            except ValueError:
                pass  # already granted and popped by _wake
            _QUEUED_QUERIES.set(len(self._waiters))

    def _give_back_racing_grant(self, fut: asyncio.Future) -> None:
        """On py3.12+ wait_for no longer returns the result when the
        future completes in the same tick as the timeout/cancel — a
        grant from _wake (which already incremented _active) would leak
        the slot permanently.  Hand it to the next waiter instead."""
        if fut.done() and not fut.cancelled():
            self.release()

    def release(self) -> None:
        self._active -= 1
        _ACTIVE_QUERIES.set(self._active)
        self.rate.record()
        self._wake()

    def retry_after_s(self) -> str:
        return _load_aware_retry_after(self.config, self.queued,
                                       self.rate.per_second())


class _TenantQueue:
    """One tenant's admission state: its FIFO wait queue, in-flight
    count, and stride-scheduling pass value, plus the pre-bound
    per-tenant gauges."""

    __slots__ = ("tenant", "waiters", "in_flight", "pass_",
                 "active_gauge", "queued_gauge")

    def __init__(self, tenant, pass_: float):
        self.tenant = tenant
        self.waiters: deque = deque()  # (arrival_seq, future)
        self.in_flight = 0
        self.pass_ = pass_
        self.active_gauge = _ACTIVE_QUERIES.labels(tenant=tenant.name)
        self.queued_gauge = _QUEUED_QUERIES.labels(tenant=tenant.name)


class FairAdmissionController:
    """Weighted-fair admission ([tenants] enabled): the global
    [admission] slot pool is granted across PER-TENANT FIFO queues by
    stride scheduling — each grant advances the tenant's virtual
    "pass" by 1/weight, and a freed slot goes to the eligible tenant
    (non-empty queue, under its max_in_flight cap) with the LOWEST
    pass, oldest arrival breaking ties.  Tenants therefore receive
    admission slots in proportion to their weights whenever they
    contend — at any pool size, regardless of how deep a flooding
    tenant's queue is — so the flood fills only its OWN queue (429s
    scoped to it) and a compliant tenant's wait stays bounded by its
    fair share, not by the abuser's backlog.  A tenant returning from
    idle re-enters at the current virtual time (no banked priority,
    no penalty), which is what makes the discipline starvation-free
    in both directions."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self._active = 0
        self._queues: dict[str, _TenantQueue] = {}
        self._arrivals = 0
        self._vtime = 0.0  # pass of the most recent grant
        self.rate = _ServiceRate()

    @property
    def active(self) -> int:
        return self._active

    def queued(self, tenant=None) -> int:
        if tenant is None:
            return sum(len(q.waiters) for q in self._queues.values())
        q = self._queues.get(tenant.name)
        return len(q.waiters) if q is not None else 0

    def occupancy(self) -> dict:
        """/stats: per-tenant admission occupancy."""
        return {name: {"in_flight": q.in_flight,
                       "queued": len(q.waiters)}
                for name, q in self._queues.items()
                if q.in_flight or q.waiters}

    def _q(self, tenant) -> _TenantQueue:
        q = self._queues.get(tenant.name)
        if q is None:
            q = self._queues[tenant.name] = _TenantQueue(
                tenant, pass_=self._vtime)
        elif q.tenant is not tenant:
            # a config reload re-points limits (weight/caps) without
            # disturbing in-flight state or queued waiters; gauges
            # rebind because the reload may have deregistered the old
            # children (a removed-then-recreated tenant must not write
            # into unrendered orphans)
            q.tenant = tenant
            q.active_gauge = _ACTIVE_QUERIES.labels(tenant=tenant.name)
            q.queued_gauge = _QUEUED_QUERIES.labels(tenant=tenant.name)
        if not q.waiters and q.in_flight == 0:
            # returning from idle: re-enter at the current virtual
            # time — an idle stretch must not bank priority (pass
            # frozen in the past) nor penalize (pass ahead of vtime
            # never happens; passes only advance on grants)
            q.pass_ = max(q.pass_, self._vtime)
        return q

    def _under_cap(self, q: _TenantQueue) -> bool:
        cap = q.tenant.limits.max_in_flight
        return cap <= 0 or q.in_flight < cap

    def _grant(self, q: _TenantQueue) -> None:
        q.in_flight += 1
        self._active += 1
        self._vtime = max(self._vtime, q.pass_)
        q.pass_ += 1.0 / q.tenant.limits.weight
        q.active_gauge.set(q.in_flight)
        _ACTIVE_QUERIES.set(self._active)

    async def acquire(self, tenant, timeout_s: Optional[float]) -> str:
        q = self._q(tenant)
        if (not q.waiters and self._under_cap(q)
                and self._active < self.config.max_concurrent_queries):
            self._grant(q)
            return "ok"
        # two queue bounds: the tenant's own max_queued (the scoped
        # shed that confines a flood), AND the operator's TOTAL
        # [admission] max_queued — enabling [tenants] must not quietly
        # turn an 8-entry queue bound into 64 x n_tenants of queued
        # memory and worst-case wait
        if (len(q.waiters) >= max(0, q.tenant.limits.max_queued)
                or self.queued() >= self.config.max_queued):
            return "shed"
        fut = asyncio.get_running_loop().create_future()
        self._arrivals += 1
        entry = (self._arrivals, fut)
        q.waiters.append(entry)
        q.queued_gauge.set(len(q.waiters))
        _QUEUED_QUERIES.set(self.queued())
        try:
            await asyncio.wait_for(fut, timeout_s)
            return "ok"
        except asyncio.TimeoutError:
            self._give_back_racing_grant(q, fut)
            return "timeout"
        except asyncio.CancelledError:
            self._give_back_racing_grant(q, fut)
            raise
        finally:
            try:
                q.waiters.remove(entry)
            except ValueError:
                pass  # granted and popped by _wake
            q.queued_gauge.set(len(q.waiters))
            _QUEUED_QUERIES.set(self.queued())

    def _give_back_racing_grant(self, q: _TenantQueue,
                                fut: asyncio.Future) -> None:
        # same py3.12+ race as the global controller: a grant landing
        # in the same tick as the timeout/cancel must be handed on
        if fut.done() and not fut.cancelled():
            self.release(q.tenant)

    def release(self, tenant) -> None:
        q = self._queues.get(tenant.name)
        if q is not None:
            q.in_flight -= 1
            q.active_gauge.set(q.in_flight)
        self._active -= 1
        _ACTIVE_QUERIES.set(self._active)
        self.rate.record()
        self._wake()

    def _wake(self) -> None:
        while self._active < self.config.max_concurrent_queries:
            best = None
            best_key = None
            for q in self._queues.values():
                while q.waiters and q.waiters[0][1].done():
                    # cancelled/timed-out head — acquire's finally
                    # prunes its own entry, this is just hygiene
                    q.waiters.popleft()
                if not q.waiters or not self._under_cap(q):
                    continue
                key = (q.pass_, q.waiters[0][0])
                if best_key is None or key < best_key:
                    best, best_key = q, key
            if best is None:
                break
            _seq, fut = best.waiters.popleft()
            best.queued_gauge.set(len(best.waiters))
            self._grant(best)
            fut.set_result(True)
        _QUEUED_QUERIES.set(self.queued())

    def retry_after_s(self, tenant) -> str:
        """Per-tenant backoff guidance: this tenant's queue depth over
        the GLOBAL observed service rate (a conservative ETA — the
        tenant's fair share drains at least this fast unless everyone
        else is idle)."""
        return _load_aware_retry_after(self.config, self.queued(tenant),
                                       self.rate.per_second())


class ServerState:
    def __init__(self, engine: MetricEngine, config: ServerConfig):
        self.engine = engine
        self.config = config
        self.write_enabled = True
        self.admission = AdmissionController(config.admission)
        # [tenants]: weighted-fair per-tenant admission + quotas; None
        # when disabled, and every tenant-aware path then falls back
        # to the exact pre-tenant global behavior
        self.tenants: Optional[TenantRegistry] = (
            TenantRegistry(config.tenants) if config.tenants.enabled
            else None)
        self.fair_admission: Optional[FairAdmissionController] = (
            FairAdmissionController(config.admission)
            if self.tenants is not None else None)
        # [trace] applies to the process-wide recorder (the ring and
        # slow-query log are one per process, like the registry)
        tracing.recorder.configure(
            enabled=config.trace.enabled,
            ring_size=config.trace.ring_size,
            slow_threshold_s=config.trace.slow_threshold.seconds,
            sample_rate=config.trace.sample_rate,
            op_ring_size=config.trace.op_ring_size,
            op_slow_threshold_s=config.trace.op_slow_threshold.seconds,
            op_sample_rate=config.trace.op_sample_rate)
        # [watchdog] applies to the process-wide loop registry the same
        # way (background loops registered at engine open included)
        loops.configure(
            enabled=config.watchdog.enabled,
            interval_s=config.watchdog.interval.seconds,
            stall_factor=config.watchdog.stall_factor,
            min_stall_s=config.watchdog.min_stall.seconds)
        # [memory] applies to the process-wide ledger: sampler cadence
        # + pressure watermarks (0 auto-derives from MemTotal;
        # pressure = false disables watermarks entirely)
        memledger.configure(
            enabled=config.memory.enabled,
            interval_s=config.memory.interval.seconds,
            soft_bytes=(config.memory.soft_limit.bytes
                        if config.memory.pressure else -1),
            hard_bytes=(config.memory.hard_limit.bytes
                        if config.memory.pressure else -1),
            hysteresis=config.memory.hysteresis)
        # [deviceprof] applies to the process-wide device profiler:
        # enable flag, storm watchdog knobs, round-timeline ring size
        deviceprof.configure(
            enabled=config.deviceprof.enabled,
            storm_window_s=config.deviceprof.storm_window.seconds,
            storm_threshold=config.deviceprof.storm_threshold,
            rounds_kept=config.deviceprof.rounds)
        # a cluster-backed server applies its [breaker] section to the
        # engine's scatter-gather policy (the setter re-points breakers
        # of already-attached remote regions too)
        if hasattr(engine, "breaker_config"):
            engine.breaker_config = config.breaker
        # [replication]: the primary-side shipping hub over this
        # engine's per-table WALs (segment listings, tail reads,
        # follower acks + the retention hook).  The lease, follower,
        # and stale-owner state wire in start_replication() — they
        # need async store I/O the constructor cannot do.
        self.repl = None
        if (config.replication.enabled
                and getattr(engine, "tables", None) is not None):
            from horaedb_tpu_torch.cluster.replication import ReplicationHub

            self.repl = ReplicationHub(engine, config.replication)
        self.lease = None
        self.follower = None
        # [failover]: the standby's self-promotion monitor (wired in
        # start_replication when this node is a follower)
        self.monitor = None
        # set when this node lost its region's lease: governed
        # endpoints answer 409 stale-owner until a fresh lease (or
        # restart) clears it — the coordinator re-resolves and retries
        self.stale_owner: Optional[dict] = None
        self._generator_tasks: list[asyncio.Task] = []

    async def start_replication(self, store) -> None:
        """Async half of [replication] wiring: claim the configured
        region's lease (fencing every flush on this engine), and/or
        start tailing a primary into the mirror."""
        cfg = self.config.replication
        if not cfg.enabled:
            return
        from horaedb_tpu_torch.cluster import replication as repl_mod

        # a node with a primary_url is a FOLLOWER: it must not claim
        # the region's lease at startup (that would fence the live
        # primary); promotion acquires it explicitly at failover time
        if cfg.region >= 0 and not cfg.primary_url:
            holder = cfg.holder or f"server:{self.config.port}"
            mgr = repl_mod.LeaseManager(store, "metrics")
            lease = await mgr.acquire(
                cfg.region, holder,
                ttl_ms=int(cfg.lease_ttl.seconds * 1000),
                url=self._advertise_url())
            lease.grant_ttl_ms(int(cfg.lease_ttl.seconds * 1000))
            lease.on_lost = self._on_lease_lost(cfg.region, lease)
            lease.start_renewal(cfg.renew_interval.seconds,
                                int(cfg.lease_ttl.seconds * 1000))
            repl_mod.install_fence(self.engine, lease)
            self.lease = lease
        if cfg.primary_url and cfg.mirror_dir:
            source = repl_mod.HttpWalSource(
                cfg.primary_url,
                follower_id=cfg.holder or f"server:{self.config.port}",
                timeout_s=cfg.rpc_timeout.seconds)
            self.follower = repl_mod.WalFollower(
                source, cfg.mirror_dir, cfg,
                region=cfg.region if cfg.region >= 0 else None)
            self.follower.start()
            if self.config.failover.enabled and cfg.region >= 0:
                # [failover]: this standby elects itself when the
                # primary's lease sits expired past the grace window
                self.monitor = repl_mod.StandbyMonitor(
                    self.follower,
                    repl_mod.LeaseManager(store, "metrics"),
                    cfg.region,
                    cfg.holder or f"server:{self.config.port}",
                    self.config.failover, self.config.wal,
                    # the promoted engine keeps this node's layout and
                    # storage config (the JAX package opens it with the
                    # defaults: ROADMAP Queue C 11)
                    segment_ms=self.config.metric_engine
                    .segment_duration.millis,
                    engine_config=self.config.metric_engine
                    .time_merge_storage,
                    lease_ttl_ms=int(cfg.lease_ttl.seconds * 1000),
                    url=self._advertise_url(),
                    on_promoted=self._on_promoted,
                    device=getattr(self.engine, "device", "cuda"))
                self.monitor.start()
        # lease-backed routing for a cluster-backed server: the 409
        # stale-owner retry re-resolves owners from live lease records
        if (getattr(self.engine, "enable_lease_routing", None)
                is not None
                and getattr(self.engine, "owner_resolver", None) is None):
            self.engine.enable_lease_routing()

    def _advertise_url(self) -> str:
        """The address peers should resolve this node's regions to —
        stamped into lease records for lease-backed routing."""
        return f"http://127.0.0.1:{self.config.port}"

    def _on_lease_lost(self, region: int, lease):
        def on_lost(exc: BaseException) -> None:
            self.stale_owner = {
                "region": region,
                "epoch": lease.epoch,
                "reason": str(exc),
            }

        return on_lost

    async def _on_promoted(self, engine, lease) -> None:
        """StandbyMonitor takeover hook: this node IS the primary now.
        Swap the served engine (handlers read `state.engine` per
        request), start the lease heartbeat, and open a shipping hub so
        the next generation of standbys can tail us.  The pre-takeover
        engine stays open — its owner (run_server / the harness)
        closes it."""
        from horaedb_tpu_torch.cluster.replication import ReplicationHub

        cfg = self.config.replication
        self.engine = engine
        self.lease = lease
        self.follower = None  # the monitor closed it pre-replay
        self.stale_owner = None
        lease.on_lost = self._on_lease_lost(lease.region, lease)
        lease.start_renewal(cfg.renew_interval.seconds,
                            int(cfg.lease_ttl.seconds * 1000))
        self.repl = ReplicationHub(engine, cfg)

    async def stop_replication(self) -> None:
        if self.monitor is not None:
            await self.monitor.close()
            self.monitor = None
        if self.follower is not None:
            await self.follower.close()
            self.follower = None
        if self.lease is not None:
            await self.lease.stop_renewal()
            self.lease = None
        if self.repl is not None:
            self.repl.close()
            self.repl = None

    # ---- write-load generator (ref: main.rs:187-233) ----------------------

    def start_generators(self) -> None:
        for worker in range(self.config.test.write_worker_num):
            self._generator_tasks.append(loops.spawn(
                lambda hb, w=worker: self._write_load_loop(hb, w),
                name=f"write-gen-{worker}", kind="write-gen",
                owner="test",
                period_s=self.config.test.write_interval.seconds))

    async def stop_generators(self) -> None:
        for t in self._generator_tasks:
            t.cancel()
        for t in self._generator_tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._generator_tasks = []

    async def _write_load_loop(self, hb, worker: int) -> None:
        interval = self.config.test.write_interval.seconds
        rng = random.Random(worker)
        while True:
            await asyncio.sleep(interval)
            hb.beat()
            if not self.write_enabled:
                continue
            now = now_ms()
            samples = [
                Sample(name=f"bench.metric{worker}",
                       labels=[Label("host", f"host-{rng.randrange(100):03d}")],
                       timestamp=now + i % 1000, value=rng.random())
                for i in range(1000)
            ]
            try:
                await self.engine.write(samples)
                hb.ok()
            except Exception as exc:  # noqa: BLE001 — next tick retries
                hb.error(exc)
                logger.exception("write-load generator failed")


def _tracing_middleware(state: ServerState):
    """Request-scoped tracing (docs/observability.md), outermost so the
    trace sees everything including the admission wait: mint (or adopt
    from X-Trace-Id — a coordinating region already traced this
    request) a trace id for every query/write, bind the trace as
    ambient context for the handler, and on completion record it into
    the trace ring, fire the slow-query log on threshold breach or a
    504, and answer with X-Trace-Id + an X-Trace-Summary stage
    breakdown.  A downstream region also exports its recorded spans on
    X-Trace-Export so the coordinator stitches ONE distributed trace."""

    del state  # config is applied to the process-global recorder

    @web.middleware
    async def middleware(request: web.Request, handler):
        path = request.path
        if path not in _QUERY_ENDPOINTS and path not in _WRITE_ENDPOINTS:
            return await handler(request)
        incoming = request.headers.get(tracing.TRACE_HEADER)
        trace_id = incoming or tracing.new_trace_id()
        # the tenant middleware is outermost, so the ambient tenant —
        # when [tenants] is on — labels the trace root
        tenant = current_tenant()
        trace = tracing.recorder.start(
            path, trace_id=trace_id, forced=incoming is not None,
            root_fields=({"tenant": tenant.name}
                         if tenant is not None else None))
        if trace is None:
            # unsampled: the id still travels (response header +
            # downstream propagation via the ambient contextvars being
            # unset is fine — peers mint their own)
            resp = await handler(request)
            resp.headers[tracing.TRACE_HEADER] = trace_id
            return resp
        status = "ok"
        with tracing.trace_scope(trace):
            try:
                resp = await handler(request)
            except DeadlineExceeded:
                tracing.recorder.finish(trace, status="timeout")
                raise
            except Exception:
                tracing.recorder.finish(trace, status="error")
                raise
        if resp.status == 504:
            status = "timeout"
        elif resp.status >= 400:
            status = "error"
        done = tracing.recorder.finish(trace, status=status)
        resp.headers[tracing.TRACE_HEADER] = trace.trace_id
        resp.headers["X-Trace-Summary"] = tracing.summarize(done)
        if incoming is not None:
            # we are a downstream region of a traced request: hand our
            # spans back for stitching
            resp.headers[tracing.EXPORT_HEADER] = tracing.export_payload(done)
        return resp

    return middleware


def _tenant_middleware(state: ServerState):
    """Tenant identity at ingress (docs/robustness.md, tenant
    isolation): resolve the X-Tenant header (absent -> the "default"
    tenant) against the [tenants] registry and bind the tenant as
    ambient context for everything below — the trace root, weighted
    -fair admission, the scan-byte budget's checkpoint hook, and the
    WAL rate gate all read it from the contextvar.  A no-op when
    [tenants] is disabled (the registry is None), so the pre-tenant
    request path is byte-for-byte unchanged."""

    @web.middleware
    async def middleware(request: web.Request, handler):
        reg = state.tenants
        path = request.path
        if reg is None or (path not in _QUERY_ENDPOINTS
                           and path not in _WRITE_ENDPOINTS):
            return await handler(request)
        try:
            tenant = reg.resolve(request.headers.get("X-Tenant"))
        except Error as e:
            return web.json_response({"error": str(e)}, status=400)
        # cluster-tier weight forwarding (cluster/remote.py): a peer
        # coordinator sends the tenant's node-tier weight alongside
        # X-Tenant so our fair scheduler grants the same share.  Only
        # AUTO-minted tenants accept it — a configured tenant's weight
        # is this node's policy, and the shared default tenant must
        # never be re-weighted by one caller for everyone
        fwd = request.headers.get("X-Tenant-Weight")
        if fwd is not None and tenant.auto:
            try:
                w = float(fwd)
            except ValueError:
                w = 0.0
            if 0.0 < w <= 1e6 and tenant.limits.weight != w:
                tenant.limits = dataclasses.replace(
                    tenant.limits, weight=w)
        t0 = time.perf_counter()
        try:
            with tenant_scope(tenant):
                return await handler(request)
        finally:
            # server-side per-tenant latency (quantiles on /stats);
            # sheds and 504s count — a tenant's experienced latency
            # includes its rejections
            tenant.query_seconds.observe(time.perf_counter() - t0)

    return middleware


def _resilience_middleware(state: ServerState):
    """Request-lifecycle robustness (docs/robustness.md): mint ONE
    Deadline per request at ingress (per-endpoint default, shrinkable
    via X-Deadline-Ms header or timeout_ms param), bind it as the
    ambient deadline every layer below budgets against, enforce it with
    a hard 504 backstop, and run query endpoints through admission
    control (429 queue-full shed / 503 queued-wait timeout, both with
    a LOAD-AWARE Retry-After derived from queue depth and the observed
    service rate).  An already-expired deadline fast-fails 504 BEFORE
    consuming an admission slot, and one that expires while queued
    answers 504 without ever holding a slot — dead requests must not
    occupy queue capacity under overload.  With [tenants] enabled,
    admission is weighted-fair over per-tenant queues and quota
    breaches (QuotaExceeded from the scan/WAL budgets) map to 429s
    scoped to the offending tenant."""

    def _labeled(counter, tenant):
        return (counter.labels(tenant=tenant.name)
                if tenant is not None else counter)

    def _timeout_504(timeout_s, tenant):
        _labeled(_DEADLINE_504, tenant).inc()
        return web.json_response(
            {"error": f"deadline exceeded ({timeout_s:.3f}s budget)"},
            status=504)

    def _quota_429(exc: QuotaExceeded, tenant):
        if tenant is not None:
            tenant.quota_rejected(exc.resource)
        return web.json_response(
            {"error": str(exc), "quota": exc.resource,
             "tenant": exc.tenant},
            status=429,
            headers={"Retry-After":
                     str(max(1, math.ceil(exc.retry_after_s)))})

    @web.middleware
    async def middleware(request: web.Request, handler):
        cfg = state.config.admission
        path = request.path
        is_query = path in _QUERY_ENDPOINTS
        is_write = path in _WRITE_ENDPOINTS
        if (is_query or is_write) and state.stale_owner is not None:
            # this node lost its region's lease mid-failover: refuse
            # data-plane traffic with 409 so the coordinator
            # re-resolves ownership and retries against the new
            # primary (cluster/replication.py StaleOwnerError)
            return web.json_response(
                {"error": "stale owner: this node's region lease was "
                          "lost", **state.stale_owner},
                status=409)
        if is_query:
            default_s = cfg.query_timeout.seconds or None
        elif is_write:
            default_s = cfg.write_timeout.seconds or None
        else:
            default_s = None  # ops/admin endpoints run unbounded
        timeout_s = default_s
        tenant = current_tenant()  # bound by the tenant middleware
        raw = (request.headers.get("X-Deadline-Ms")
               or request.query.get("timeout_ms"))
        if raw is not None:
            try:
                asked_s = int(raw) / 1000.0
            except ValueError:
                return web.json_response(
                    {"error": f"bad deadline: {raw!r}"}, status=400)
            if asked_s <= 0 and (is_query or is_write):
                # dead on arrival: the client declared its budget
                # already spent — 504 before any slot, queue entry,
                # WAL frame, or fsync is consumed
                _labeled(_DEADLINE_504, tenant).inc()
                return web.json_response(
                    {"error": "deadline exceeded (budget spent before "
                              "arrival)"}, status=504)
            cap = cfg.max_timeout.seconds or None
            timeout_s = max(0.001, min(asked_s, cap) if cap else asked_s)
        if (tenant is not None and (is_query or is_write)
                and tenant.limits.max_query_time.seconds > 0):
            # operator-side per-tenant deadline cap: a no-SLO class
            # cannot hold server time past its envelope, whatever the
            # client asked for
            tcap = tenant.limits.max_query_time.seconds
            timeout_s = tcap if timeout_s is None else min(timeout_s,
                                                           tcap)
        deadline = (Deadline.after(timeout_s, reason=path)
                    if timeout_s is not None else None)
        fair = state.fair_admission if tenant is not None else None
        # fast-fail: a request that arrives already out of time is
        # answered 504 here, before it can consume an admission slot
        # or queue capacity
        if ((is_query or is_write) and deadline is not None
                and deadline.remaining() <= 0.0):
            return _timeout_504(timeout_s, tenant)
        admitted = False
        try:
            if cfg.enabled and is_query:
                wait_s = cfg.queue_timeout.seconds
                if deadline is not None:
                    wait_s = deadline.budget(wait_s)
                with span("admission_wait",
                          queued=(fair.queued(tenant)
                                  if fair is not None
                                  else state.admission.queued)):
                    if fair is not None:
                        outcome = await fair.acquire(tenant, wait_s)
                    else:
                        outcome = await state.admission.acquire(wait_s)
                if (outcome == "ok" and deadline is not None
                        and deadline.expired):
                    # the grant raced the expiry: give the slot back —
                    # a dead request must not occupy it
                    if fair is not None:
                        fair.release(tenant)
                    else:
                        state.admission.release()
                    return _timeout_504(timeout_s, tenant)
                if outcome == "shed":
                    _labeled(_SHED, tenant).inc()
                    retry = (fair.retry_after_s(tenant)
                             if fair is not None
                             else state.admission.retry_after_s())
                    scope = (f" for tenant {tenant.name!r}"
                             if tenant is not None else "")
                    return web.json_response(
                        {"error": "overloaded: admission queue full"
                                  + scope},
                        status=429, headers={"Retry-After": retry})
                if outcome == "timeout":
                    if deadline is not None and deadline.expired:
                        # expired while queued: the request is dead —
                        # 504, and it never held a slot
                        return _timeout_504(timeout_s, tenant)
                    _labeled(_QUEUE_TIMEOUTS, tenant).inc()
                    retry = (fair.retry_after_s(tenant)
                             if fair is not None
                             else state.admission.retry_after_s())
                    return web.json_response(
                        {"error": "overloaded: timed out waiting for a "
                                  "query slot"},
                        status=503, headers={"Retry-After": retry})
                admitted = True
            with deadline_scope(deadline):
                try:
                    if deadline is None or is_write:
                        # writes are deadline-SCOPED (each outgoing RPC
                        # budgets against it) but never hard-cancelled:
                        # aborting a multi-region commit mid-flight
                        # would break the write path's no-partial-commit
                        # retry-safety discipline
                        return await handler(request)
                    # queries are idempotent: hard backstop around the
                    # cooperative checkpoints — even a handler that
                    # never checkpoints cannot overrun its deadline
                    return await asyncio.wait_for(handler(request),
                                                  deadline.remaining())
                except QuotaExceeded as exc:
                    # a per-tenant resource budget fired (scan bytes at
                    # a checkpoint, WAL rate ahead of group commit):
                    # 429 scoped to the tenant, Retry-After from the
                    # bucket's actual deficit
                    return _quota_429(exc, tenant)
                except (asyncio.TimeoutError, DeadlineExceeded):
                    if deadline is None:
                        raise  # not ours: no deadline was bound
                    deadline.cancel()
                    return _timeout_504(timeout_s, tenant)
        finally:
            if admitted:
                if fair is not None:
                    fair.release(tenant)
                else:
                    state.admission.release()

    return middleware


def _tenant_stats(state: ServerState) -> dict:
    """Per-tenant isolation state: quotas, server-side latency
    quantiles, and live admission occupancy — the shared body of the
    /stats `tenants` section and GET /admin/tenants."""
    tstats = state.tenants.stats()
    for name, occ in state.fair_admission.occupancy().items():
        tstats.setdefault(name, {}).update(occ)
    return tstats


def build_app(state: ServerState) -> web.Application:
    routes = web.RouteTableDef()

    def _error_response(e: Error) -> web.Response:
        """Client-error mapping shared by every handler.  Request
        -deadline expiry re-raises so the middleware answers 504; a
        STORAGE-side deadline overrun (objstore retry middleware's
        per-op deadline) is the server's problem, not the client's —
        503, never 400."""
        from horaedb_tpu_torch.objstore.middleware import DeadlineExceededError

        if isinstance(e, (DeadlineExceeded, QuotaExceeded)):
            # the resilience middleware owns these mappings (504 and
            # the tenant-scoped quota 429 respectively)
            raise e
        if isinstance(e, DeadlineExceededError):
            return web.json_response({"error": str(e)}, status=503)
        return web.json_response({"error": str(e)}, status=400)

    def _attach_partial(body: dict, meta) -> dict:
        """Degraded scatter-gather marker on /query* JSON bodies (meta
        is None for single-engine servers — shape unchanged)."""
        if meta is not None:
            body["partial"] = meta.partial
            body["missing_regions"] = meta.missing_regions
        return body

    def _partial_headers(meta) -> dict:
        """The same marker for Arrow responses, as HTTP headers (the
        IPC stream body stays pure data)."""
        if meta is None:
            return {}
        headers = {"X-Partial": "true" if meta.partial else "false"}
        if meta.missing_regions:
            headers["X-Missing-Regions"] = ",".join(
                str(r) for r in meta.missing_regions)
        return headers

    async def _engine_query(metric, filters, rng, field):
        """Row query with degraded gather when the engine is a Cluster
        (returns (table, GatherMeta|None))."""
        gather = getattr(state.engine, "query_gather", None)
        if gather is not None:
            return await gather(metric, filters, rng, field=field)
        tbl = await state.engine.query(metric, filters, rng, field=field)
        return tbl, None

    async def _engine_downsample(metric, filters, rng, bucket_ms, field):
        """Downsample with degraded gather when the engine is a Cluster;
        the grids come back as host arrays either way."""
        gather = getattr(state.engine, "query_downsample_gather", None)
        if gather is not None:
            out, meta = await gather(metric, filters, rng, bucket_ms,
                                     field=field)
            return host_downsample(out), meta
        out = await state.engine.query_downsample(metric, filters, rng,
                                                  bucket_ms, field=field)
        return host_downsample(out), None

    @routes.get("/")
    async def hello(_req: web.Request) -> web.Response:
        return web.Response(text="Hello, horaedb-tpu!")

    @routes.get("/toggle")
    async def toggle(_req: web.Request) -> web.Response:
        state.write_enabled = not state.write_enabled
        return web.Response(text=f"write_enabled={state.write_enabled}")

    @routes.get("/compact")
    async def compact(_req: web.Request) -> web.Response:
        tables = getattr(state.engine, "tables", None)
        if tables is None:
            return web.json_response(
                {"error": "compaction is a per-node operation; this "
                          "server fronts a cluster — compact each "
                          "region's own server"}, status=501)
        for table in tables.values():
            await table.compact()
        rollups = getattr(state.engine, "rollups", None)
        if rollups is not None:
            for table in rollups.tiers.values():
                await table.compact()
        return web.Response(text="compaction triggered")

    @routes.get("/metrics")
    async def metrics(_req: web.Request) -> web.Response:
        return web.Response(text=registry.render(),
                            content_type="text/plain")

    @routes.post("/admin/scrub")
    async def admin_scrub(req: web.Request) -> web.Response:
        """On-demand orphan scrub across every table (storage/gc.py).
        Optional ?grace_ms= overrides the configured grace period for
        this pass only (grace_ms=0 reclaims everything currently
        observed as orphaned — operator big-hammer, use with care)."""
        grace_s = None
        raw = req.query.get("grace_ms")
        if raw is not None:
            try:
                grace_s = int(raw) / 1000.0
            except ValueError:
                return web.json_response(
                    {"error": f"bad grace_ms: {raw!r}"}, status=400)
        tables = getattr(state.engine, "tables", None)
        if tables is None:
            # cluster-backed servers have no direct table surface;
            # scrub each region's node instead
            return web.json_response(
                {"error": "scrub is a per-node operation; this server "
                          "fronts a cluster — scrub each region's own "
                          "server"}, status=501)
        out = {}
        for name, table in tables.items():
            report = await table.scrub(grace_override_s=grace_s)
            out[name] = report.as_dict()
        rollups = getattr(state.engine, "rollups", None)
        if rollups is not None:
            for tier_ms, table in rollups.tiers.items():
                report = await table.scrub(grace_override_s=grace_s)
                out[f"rollup_{rollups.tier_names[tier_ms]}"] = \
                    report.as_dict()
        return web.json_response(out)

    @routes.get("/debug/traces")
    async def debug_traces(req: web.Request) -> web.Response:
        """Newest-first summaries of recently completed traces
        (?limit=N, default 50; docs/observability.md).  ?kind=query|op
        restricts to one trace population (default: both, merged);
        ?op=<name> to one background op (compaction, flush, wal_commit,
        rollup_pass, scrub, health_round, meta_scrape — implies
        kind=op)."""
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            return web.json_response(
                {"error": f"bad limit: {req.query.get('limit')!r}"},
                status=400)
        kind = req.query.get("kind", "all")
        if kind not in ("all", "query", "op"):
            return web.json_response(
                {"error": f"bad kind: {kind!r} (query|op|all)"},
                status=400)
        op = req.query.get("op")
        return web.json_response(
            {"traces": tracing.recorder.list(limit, kind=kind, op=op)})

    @routes.get("/debug/tasks")
    async def debug_tasks(_req: web.Request) -> web.Response:
        """The background-loop registry (common/loops.py): every loop's
        liveness, heartbeat age, stall flag, last success, consecutive
        errors + last error, and backlog hints (WAL backlog bytes,
        dirty rollup segments, pending compaction tasks).  This is the
        maintenance plane's /debug/traces."""
        return web.json_response({
            "loops": loops.snapshot(),
            "watchdog": {
                "enabled": loops.enabled,
                "interval_s": loops.interval_s,
                "stall_factor": loops.stall_factor,
                "min_stall_s": loops.min_stall_s,
            },
        })

    @routes.get("/debug/memory")
    async def debug_memory(_req: web.Request) -> web.Response:
        """The memory ledger (common/memledger.py): the full account
        tree (bytes/budget/utilization/high-water per kind, instance
        detail), RSS, unattributed = RSS - Σ accounts (leaks positive,
        double counting negative), pressure watermark state, and
        per-device accelerator bytes where the backend reports them.
        This is the byte-plane twin of /debug/tasks."""
        return web.json_response(memledger.snapshot())

    @routes.get("/debug/device")
    async def debug_device(_req: web.Request) -> web.Response:
        """The device plane (common/deviceprof.py): the seam table
        (per-seam calls, kernel launches, dispatch and device seconds,
        distinct call keys, storm state, the nvcc builds), h2d/d2h
        transfer totals, the mesh round timeline (slot fill, padding
        waste, per-shard row imbalance), and per-device memory."""
        out = deviceprof.snapshot()
        sample = memledger.sample_once()
        out["devices"] = sample.get("devices", [])
        return web.json_response(out)

    @routes.get("/debug/traces/{trace_id}")
    async def debug_trace(req: web.Request) -> web.Response:
        """One trace as a JSON span tree: per-stage durations, cache
        tier hits, object-store GETs/bytes — stitched across regions
        when the query scatter-gathered."""
        trace_id = req.match_info["trace_id"]
        d = tracing.recorder.get(trace_id)
        if d is None:
            return web.json_response(
                {"error": f"trace {trace_id!r} not in the ring (expired "
                          "or never sampled)"}, status=404)
        out = tracing.span_tree(d)
        out["summary"] = tracing.summarize(d)
        return web.json_response(out)

    @routes.get("/stats")
    async def stats(_req: web.Request) -> web.Response:
        # data-volume load signal for cluster rebalancing (rows/bytes/
        # SSTs per table from the manifests) + the ingest plane's
        # buffered state (memtable rows/bytes, WAL backlog, flush age)
        # + the maintenance plane's health rollup (stalled/erroring
        # loops — degraded maintenance surfaces BEFORE query latency)
        out = await state.engine.stats()
        out["loops"] = loops.summary()
        # the memory plane's compact rollup (full tree on /debug/memory)
        out["memory"] = memledger.summary()
        # the device plane's compact rollup (full table on /debug/device)
        out["deviceprof"] = deviceprof.summary()
        if state.tenants is not None:
            out["tenants"] = _tenant_stats(state)
        return web.json_response(out)

    @routes.post("/admin/flush")
    async def admin_flush(_req: web.Request) -> web.Response:
        """Force-drain every WAL-fronted memtable to SSTs now (and
        advance WAL truncation).  No-op tables report nothing; a
        cluster-front server has no local tables to flush."""
        flush = getattr(state.engine, "flush", None)
        if flush is None:
            return web.json_response(
                {"error": "flush is a per-node operation; this server "
                          "fronts a cluster — flush each region's own "
                          "server"}, status=501)
        try:
            return web.json_response(await flush())
        except Error as e:
            return _error_response(e)

    @routes.get("/admin/rollups")
    async def admin_rollups_status(_req: web.Request) -> web.Response:
        """Standing-rollup status: per-spec lag (newest raw seq vs
        newest rolled-up seq), segment coverage, serve counters, and
        per-tier cell volume (docs/rollups.md)."""
        rollups = getattr(state.engine, "rollups", None)
        if rollups is None:
            return web.json_response(
                {"error": "rollups are not enabled on this server "
                          "([rollup] enabled = true)"}, status=501)
        return web.json_response(await rollups.stats())

    @routes.post("/admin/rollups")
    async def admin_rollups(req: web.Request) -> web.Response:
        """Register a standing downsample query: {"metric", "field"?}.
        Optional {"roll": true} runs a synchronous maintenance pass
        (initial backfill / test hook) before answering; registration
        alone backfills on the next background pass."""
        rollups = getattr(state.engine, "rollups", None)
        if rollups is None:
            return web.json_response(
                {"error": "rollups are not enabled on this server "
                          "([rollup] enabled = true)"}, status=501)
        try:
            body = await req.json()
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            metric = body.get("metric")
            field = str(body.get("field", "value"))
            roll = bool(body.get("roll", False))
            if metric is not None and not isinstance(metric, str):
                raise ValueError("metric must be a string")
        except (TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        try:
            if metric:
                await rollups.register(metric, field)
            rolled = await rollups.roll_now() if roll else None
        except Error as e:
            return _error_response(e)
        out = await rollups.stats()
        if rolled is not None:
            out["rolled_segments"] = rolled
        return web.json_response(out)

    @routes.get("/admin/tenants")
    async def admin_tenants_status(_req: web.Request) -> web.Response:
        """Per-tenant isolation state: configured limits, quota bucket
        levels, server-side latency quantiles, admission occupancy."""
        if state.tenants is None:
            return web.json_response(
                {"error": "tenants are not enabled on this server "
                          "([tenants] enabled = true)"}, status=501)
        return web.json_response({"enabled": True,
                                  "tenants": _tenant_stats(state)})

    @routes.post("/admin/tenants")
    async def admin_tenants(req: web.Request) -> web.Response:
        """Reload the [tenants] table at runtime: the body is a
        [tenants]-shaped JSON object (default/tenant/auto knobs).
        Limits re-point live (queued waiters keep their place); bucket
        levels reset (a reload is a policy change, not an accounting
        continuation); tenants REMOVED from the config have their
        metric children deregistered so /metrics stops serving them.
        Toggling `enabled` requires a restart — the middleware chain
        is fixed at startup."""
        if state.tenants is None:
            return web.json_response(
                {"error": "tenants are not enabled on this server "
                          "([tenants] enabled = true)"}, status=501)
        try:
            body = await req.json()
            if not isinstance(body, dict):
                raise Error("body must be a JSON object")
            body.setdefault("enabled", True)
            new_cfg = tenants_from_dict(body)
            ensure(new_cfg.enabled,
                   "cannot disable [tenants] at runtime; restart with "
                   "enabled = false")
        except (TypeError, ValueError, Error) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        removed = state.tenants.configure(new_cfg)
        tstats = state.tenants.stats()
        return web.json_response({"removed": removed, "tenants": tstats})

    @routes.post("/admin/rebalance")
    async def admin_rebalance(req: web.Request) -> web.Response:
        """Hot-shard recommendation hook: the cluster's health monitor
        keeps a split/rebalance proposal from its per-region load
        survey (cluster.py, surfaced on /debug/tasks too); this
        endpoint recomputes it on demand.  ?skew_ratio= overrides the
        flag threshold for this call.  The operator (or an external
        controller) executes the moves — this node cannot know its
        peers' capacities."""
        survey = getattr(state.engine, "survey_load", None)
        if survey is None:
            return web.json_response(
                {"error": "rebalance is a cluster-tier operation; this "
                          "server fronts a single engine"}, status=501)
        skew = None
        raw = req.query.get("skew_ratio")
        if raw is not None:
            try:
                skew = float(raw)
                ensure(skew > 1.0, "skew_ratio must be > 1")
            except (ValueError, Error):
                return web.json_response(
                    {"error": f"bad skew_ratio: {raw!r}"}, status=400)
        out = await (survey(skew_ratio=skew) if skew is not None
                     else survey())
        return web.json_response(out)

    @routes.post("/write")
    async def write(req: web.Request) -> web.Response:
        try:
            body = await req.json()
            samples = [
                Sample(name=s["name"],
                       labels=[Label(k, str(v))
                               for k, v in sorted(s.get("labels", {}).items())],
                       timestamp=int(s["timestamp"]), value=float(s["value"]),
                       field_name=s.get("field", "value"))
                for s in body["samples"]
            ]
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        try:
            await state.engine.write(samples)
        except Error as e:
            return _error_response(e)
        return web.json_response({"written": len(samples)})

    @routes.post("/write_arrow")
    async def write_arrow(req: web.Request) -> web.Response:
        """Bulk columnar ingest: the body is an Arrow IPC stream (one or
        more record batches with [tags..., timestamp, value] columns);
        metric and tag columns come from query params.  This is the
        Arrow-IPC data plane — no per-row JSON, C++ decode straight into
        the vectorized ingest path."""
        import pyarrow.ipc

        metric = req.query.get("metric")
        if not metric:
            return web.json_response({"error": "metric param required"},
                                     status=400)
        tags = [t for t in req.query.get("tags", "").split(",") if t]
        field = req.query.get("field", "value")
        body = await req.read()
        try:
            reader = pyarrow.ipc.open_stream(body)
            table = reader.read_all()
        except Exception as e:  # arrow raises several types here
            return web.json_response({"error": f"bad arrow stream: {e}"},
                                     status=400)
        written = 0
        try:
            for batch in table.combine_chunks().to_batches():
                await state.engine.write_arrow(metric, tags, batch,
                                               field=field)
                written += batch.num_rows
        except Error as e:
            return _error_response(e)
        return web.json_response({"written": written})

    def _parse_query_body(body: dict):
        """Shared /query + /query_arrow request parsing.  The dict filter
        form loses duplicate keys; the list-of-pairs form (RemoteRegion
        sends it) preserves them.  bucket_ms converts HERE so a
        non-numeric value is a 400, not a 500 mid-handler."""
        metric = body["metric"]
        raw_filters = body.get("filters", {})
        if isinstance(raw_filters, dict):
            filters = sorted(raw_filters.items())
        else:
            filters = sorted((str(k), str(v)) for k, v in raw_filters)
        rng = TimeRange.new(int(body["start"]), int(body["end"]))
        field = body.get("field", "value")
        bucket_ms = body.get("bucket_ms")
        bucket_ms = int(bucket_ms) if bucket_ms else None
        return metric, filters, rng, field, bucket_ms

    def _resolve_fn(fn):
        """Whitelisted rate-family post-functions.  Explicit whitelist:
        getattr dispatch would accept module attributes (fn="np") and
        500 on call.  Returns (impl, error_response)."""
        from horaedb_tpu_torch.metric_engine import functions

        supported = {"rate": functions.rate,
                     "increase": functions.increase,
                     "delta": functions.delta}
        impl = supported.get(fn) if isinstance(fn, str) else None
        if impl is None:
            return None, web.json_response(
                {"error": f"unknown fn {fn!r}; supported: "
                          f"{sorted(supported)}"}, status=400)
        return impl, None

    @routes.post("/query")
    async def query(req: web.Request) -> web.Response:
        try:
            body = await req.json()
            metric, filters, rng, field, bucket_ms = _parse_query_body(body)
            fn = body.get("fn")
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        # reject an unknown fn BEFORE paying for the scan
        impl = None
        if bucket_ms and fn is not None:
            impl, err = _resolve_fn(fn)
            if err is not None:
                return err
        try:
            if bucket_ms:
                out, meta = await _engine_downsample(metric, filters, rng,
                                                     bucket_ms, field)
                body_out = _downsample_json(out)
                if impl is not None and out["tsids"]:
                    body_out["aggs"][fn] = _grid_json(
                        impl(out["aggs"], bucket_ms))
                return web.json_response(_attach_partial(body_out, meta))
            tbl, meta = await _engine_query(metric, filters, rng, field)
            return web.json_response(_attach_partial({
                "tsids": [str(t) for t in tbl.column("tsid").to_pylist()],
                "timestamps": tbl.column("timestamp").to_pylist(),
                "values": tbl.column("value").to_pylist()}, meta))
        except Error as e:
            return _error_response(e)

    @routes.post("/query_topk")
    async def query_topk(req: web.Request) -> web.Response:
        """Top-k series by one aggregate over the window (BASELINE
        config 4's shape), via the engine's TopK QueryPlan stage.  Body:
        {metric, filters?, start, end, bucket_ms, k, by?, largest?,
        field?} — results come back best-first."""
        try:
            body = await req.json()
            metric, filters, rng, field, bucket_ms = _parse_query_body(body)
            if not bucket_ms:
                raise ValueError("bucket_ms is required")
            k = int(body["k"])
            if k < 1:
                raise ValueError("k must be >= 1")
            by = str(body.get("by", "max"))
            largest = bool(body.get("largest", True))
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        try:
            out = await state.engine.query_topk(
                metric, filters, rng, bucket_ms, k=k, by=by,
                largest=largest, field=field)
        except Error as e:
            return _error_response(e)
        return web.json_response(_downsample_json(host_downsample(out)))

    @routes.post("/query_multi")
    async def query_multi(req: web.Request) -> web.Response:
        """Downsample SEVERAL fields of one metric in one request (one
        resolve, per-field pushdown scans).  Body: {metric, filters?,
        start, end, bucket_ms, fields: [..]}; response maps field ->
        the /query downsample shape."""
        try:
            body = await req.json()
            metric, filters, rng, field, bucket_ms = _parse_query_body(body)
            if not bucket_ms:
                raise ValueError("bucket_ms is required")
            fields = body["fields"]
            if (not isinstance(fields, list) or not fields
                    or not all(isinstance(f, str) for f in fields)):
                raise ValueError("fields must be a non-empty list of "
                                 "strings")
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        try:
            outs = await state.engine.query_downsample_multi(
                metric, filters, rng, bucket_ms, fields=fields)
        except Error as e:
            return _error_response(e)
        return web.json_response({f: _downsample_json(host_downsample(out))
                                  for f, out in outs.items()})

    @routes.post("/query_arrow")
    async def query_arrow(req: web.Request) -> web.Response:
        """Like POST /query but the response body is an Arrow IPC
        stream — the symmetric read side of the Arrow data plane.  With
        "bucket_ms" the response is the downsample-grid encoding
        (common.ipc.downsample_to_arrow): one row per series, each
        aggregate a FixedSizeList<f64>[num_buckets] column — the
        region-to-region hop's format (JSON grids decimal-print every
        cell; zstd'd Arrow is 2.6x fewer wire bytes on random grids,
        more on real data)."""
        from horaedb_tpu_torch.common.ipc import (COMPRESSIONS,
                                            downsample_to_arrow,
                                            serialize_stream)

        try:
            body = await req.json()
            metric, filters, rng, field, bucket_ms = _parse_query_body(body)
            fn = body.get("fn")
            # compressed IPC buffers are OPT-IN ("compression": "zstd"):
            # time-series columns compress well on the wire, but not
            # every Arrow implementation ships every codec
            compression = body.get("compression")
            if compression not in COMPRESSIONS:
                raise ValueError(f"unsupported compression {compression!r}")
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        # reject an unknown fn BEFORE paying for the scan
        impl = None
        if bucket_ms and fn is not None:
            impl, err = _resolve_fn(fn)
            if err is not None:
                return err
        try:
            if bucket_ms:
                out, meta = await _engine_downsample(metric, filters, rng,
                                                     bucket_ms, field)
                if impl is not None and out["tsids"]:
                    out["aggs"][fn] = impl(out["aggs"], bucket_ms)
                tbl = downsample_to_arrow(out)
            else:
                tbl, meta = await _engine_query(metric, filters, rng,
                                                field)
        except Error as e:
            return _error_response(e)
        return web.Response(body=serialize_stream(tbl, compression),
                            headers=_partial_headers(meta),
                            content_type="application/vnd.apache.arrow.stream")

    @routes.get("/label_names")
    async def label_names(req: web.Request) -> web.Response:
        try:
            metric = req.query["metric"]
            rng = TimeRange.new(int(req.query["start"]), int(req.query["end"]))
        except (KeyError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        return web.json_response(
            {"names": await state.engine.label_names(metric, rng)})

    @routes.get("/metrics_list")
    async def metrics_list(req: web.Request) -> web.Response:
        try:
            rng = TimeRange.new(int(req.query["start"]), int(req.query["end"]))
        except (KeyError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        return web.json_response(
            {"metrics": await state.engine.list_metrics(rng)})

    @routes.get("/label_values")
    async def label_values(req: web.Request) -> web.Response:
        try:
            metric = req.query["metric"]
            key = req.query["key"]
            rng = TimeRange.new(int(req.query["start"]), int(req.query["end"]))
        except (KeyError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"}, status=400)
        try:
            gather = getattr(state.engine, "label_values_gather", None)
            if gather is not None:
                vals, meta = await gather(metric, key, rng)
                return web.json_response(
                    _attach_partial({"values": vals}, meta))
            vals = await state.engine.label_values(metric, key, rng)
        except Error as e:
            return _error_response(e)
        return web.json_response({"values": vals})

    # ---- replication ops plane (cluster/replication.py) -------------------
    # Ungoverned: followers bound every RPC client-side (HttpWalSource
    # carries an explicit timeout + X-Deadline-Ms), and shipping must
    # keep draining even when the admission gate is shedding client
    # load — replication lag during overload makes failover WORSE.

    @routes.get("/repl/wal/segments")
    async def repl_segments(req: web.Request) -> web.Response:
        if state.repl is None:
            return web.json_response(
                {"error": "replication not enabled on this node"},
                status=501)
        follower = req.query.get("follower")
        return web.json_response(state.repl.snapshot(follower_id=follower))

    @routes.get("/repl/wal/read")
    async def repl_read(req: web.Request) -> web.Response:
        if state.repl is None:
            return web.json_response(
                {"error": "replication not enabled on this node"},
                status=501)
        try:
            log = req.query["log"]
            segment = int(req.query["segment"])
            offset = int(req.query["offset"])
            max_bytes = int(req.query["max_bytes"])
        except (KeyError, ValueError) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        if offset < 0 or max_bytes <= 0:
            # range-check here: out-of-range values trip Wal.read_tail's
            # internal ensure(), which would surface as a 500
            return web.json_response(
                {"error": "bad request: offset must be >= 0 and "
                          "max_bytes > 0"}, status=400)
        out = await state.repl.read_tail(log, segment, offset, max_bytes)
        if out is None:
            # segment truncated (or unknown log): the follower resyncs
            # from a fresh listing instead of treating this as an error
            return web.Response(body=b"", headers={"X-Wal-Gone": "1"})
        blob, sealed = out
        return web.Response(body=blob,
                            headers={"X-Wal-Sealed": "1" if sealed else "0"},
                            content_type="application/octet-stream")

    @routes.post("/repl/wal/ack")
    async def repl_ack(req: web.Request) -> web.Response:
        if state.repl is None:
            return web.json_response(
                {"error": "replication not enabled on this node"},
                status=501)
        try:
            body = await req.json()
            follower = str(body["follower"])
            acks = {str(k): int(v) for k, v in body["acks"].items()}
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            return web.json_response({"error": f"bad request: {e}"},
                                     status=400)
        state.repl.ack(follower, acks)
        return web.json_response({"ok": True})

    @routes.get("/repl/status")
    async def repl_status(req: web.Request) -> web.Response:
        body: dict = {"role": "none"}
        if state.repl is not None:
            body = state.repl.status()
            body["role"] = "primary"
        elif state.follower is not None:
            body["role"] = "follower"
            body["lag_seqs"] = state.follower.lag()
            body["shipped_seqs"] = dict(state.follower.shipped_seqs)
        if state.monitor is not None:
            # [failover]: a node running a standby monitor is a
            # STANDBY until it wins an election — even though it also
            # carries a shipping hub (cascading standbys tail it), the
            # monitor's role is the truth.  The election dict (observed
            # epoch, grace deadline, last outcome) is the same one the
            # monitor's loop backlog serves on /debug/tasks.
            election = state.monitor.election_state()
            if election["role"] == "standby":
                body["role"] = "standby"
            body["election"] = election
        if state.lease is not None:
            body["lease"] = {"region": state.lease.region,
                             "epoch": state.lease.epoch,
                             "lost": state.lease.lost}
        if state.stale_owner is not None:
            body["stale_owner"] = state.stale_owner
        return web.json_response(body)

    # sized for the Arrow-IPC bulk data plane (default 1 MiB would 413
    # any real ingest batch); the tenant middleware is outermost (the
    # identity must be ambient before the trace roots and the
    # admission decision), then tracing so the trace covers the
    # admission wait and the 504 mapping
    app = web.Application(client_max_size=256 * 1024 * 1024,
                          middlewares=[_tenant_middleware(state),
                                       _tracing_middleware(state),
                                       _resilience_middleware(state)])
    app.add_routes(routes)
    return app


def _grid_json(grid) -> list:
    out = []
    for row in grid.tolist():
        out.append([None if isinstance(x, float) and math.isnan(x) else x
                    for x in row])
    return out


def _downsample_json(out: dict) -> dict:
    """THE wire shape of a downsample result, shared by /query,
    /query_topk and /query_multi so the endpoints cannot drift."""
    return {"tsids": [str(t) for t in out["tsids"]],
            "num_buckets": out["num_buckets"],
            "aggs": {k: _grid_json(v) for k, v in out["aggs"].items()}}


def _build_store(config: ServerConfig):
    from horaedb_tpu_torch.objstore import InstrumentedStore

    oc = config.metric_engine.object_store
    if oc.kind == "S3Like":
        from horaedb_tpu_torch.objstore.s3 import S3ObjectStore, S3Options

        # built inside the server's loop: the store's aiohttp session is
        # made at its first request and belongs to that loop
        store = S3ObjectStore(S3Options(
            endpoint=oc.s3.endpoint, region=oc.s3.region or "us-east-1",
            bucket=oc.s3.bucket, access_key_id=oc.s3.key_id,
            secret_access_key=oc.s3.key_secret, prefix=oc.s3.prefix,
            max_retries=oc.s3.max_retries))
    else:
        store = LocalObjectStore(oc.data_dir)
    # per-op objstore counters/latency histograms surface at /metrics
    return InstrumentedStore(store)


async def run_server(config: ServerConfig,
                     ready: Optional[asyncio.Event] = None,
                     device="cuda") -> None:
    """Open the engine on `device` ("cuda" by default; raises without a
    card), serve until cancelled, then close everything it opened."""
    import os

    store = _build_store(config)
    wal_config = config.wal
    if wal_config.enabled and not wal_config.dir:
        # the WAL lives beside the Local object-store root (load_config
        # rejects empty-dir WAL on remote stores)
        wal_config = dataclasses.replace(
            wal_config,
            dir=os.path.join(config.metric_engine.object_store.data_dir,
                             "wal"))
    engine = await MetricEngine.open(
        "metrics", store,
        segment_ms=config.metric_engine.segment_duration.millis,
        config=config.metric_engine.time_merge_storage,
        chunked_data=config.metric_engine.chunked_data,
        chunk_window_ms=config.metric_engine.chunk_window.millis,
        wal_config=wal_config, rollup_config=config.rollup,
        meta_config=config.meta, scanagent_config=config.scanagent,
        device=device)
    state = ServerState(engine, config)
    runner = None
    try:
        await state.start_replication(store)
        if config.test.enable_write:
            state.start_generators()
        app = build_app(state)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", config.port)
        await site.start()
        logger.info("listening on 127.0.0.1:%d (device %s)", config.port,
                    engine.device)
        if ready is not None:
            ready.set()
        while True:
            await asyncio.sleep(3600)
    finally:
        await state.stop_generators()
        await state.stop_replication()
        if runner is not None:
            await runner.cleanup()
        # a standby that won its election serves the promoted engine;
        # close it too
        if state.engine is not engine:
            await state.engine.close()
        await engine.close()
        closer = getattr(store, "close", None)
        if closer is not None:
            await closer()


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s:%(lineno)d %(message)s")
    parser = argparse.ArgumentParser("horaedb-tpu-torch-server")
    parser.add_argument("--config", default=None, help="TOML config path")
    parser.add_argument("--device", default="cuda",
                        help='torch device of the engine ("cuda" by '
                             'default; "cpu" for tests)')
    args = parser.parse_args()
    config = load_config(args.config)
    asyncio.run(_serve(config, args.device))


async def _serve(config: ServerConfig, device) -> None:
    """run_server until SIGTERM or SIGINT, which cancel it: its cleanup
    closes the engine and the process exits 0."""
    loop = asyncio.get_running_loop()
    task = asyncio.current_task()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, task.cancel)
    try:
        await run_server(config, device=device)
    except asyncio.CancelledError:
        logger.info("server stopped")


if __name__ == "__main__":
    main()
