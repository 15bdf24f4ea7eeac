"""Cluster facade: routed writes + scatter-gather queries over regions.

Each region is a full MetricEngine (its own tables, manifest, compaction)
under `{root}/region_{id}`, opened on the cluster's torch device.  The
gather merges regions' numpy grids on the host
(storage/combine.merge_downsample_results), so a remote region's grids
and a local one's fold alike.  Series are partitioned by routing_key, so in
a steady-state layout each series lives in one region and gather is a
plain concatenation.  During a split's TTL window the SAME series can
have pre-split rows in the old region and post-split rows in the new one
— rows for one tsid may then arrive from two regions (still no duplicate
(series, timestamp) points, since each write went to exactly one region);
consumers must not assume per-region series disjointness until the old
rule ages out.  (The reference's legacy system forwards via HoraeMeta +
gRPC the same way, SURVEY.md P6.)
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import pyarrow as pa

from horaedb_tpu_torch.common import deadline as deadline_mod
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.time_ext import now_ms
from horaedb_tpu_torch.cluster.breaker import (CLOSED as BREAKER_CLOSED,
                                         BreakerConfig, CircuitBreaker)
from horaedb_tpu_torch.cluster.router import RoutingTable, routing_key
from horaedb_tpu_torch.metric_engine import MetricEngine, Sample
from horaedb_tpu_torch.objstore import ObjectStore
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import op_trace, registry, span

logger = logging.getLogger(__name__)

_GATHER_PARTIAL = registry.counter(
    "cluster_gather_partial_total",
    "scatter-gather queries answered with one or more regions missing")
_RPC_TIMEOUTS = registry.counter(
    "cluster_region_rpc_timeouts_total",
    "remote region RPC attempts that hit their timeout budget")
_RPC_RETRIES = registry.counter(
    "cluster_region_rpc_retries_total",
    "bounded single-retry attempts against remote regions")
_HEDGES = registry.counter(
    "cluster_hedged_rpcs_total",
    "hedge requests fired after the hedge delay elapsed")
_HEDGE_WINS = registry.counter(
    "cluster_hedge_wins_total",
    "hedged requests that beat the primary attempt")
_HEALTH_ERRORS = registry.counter(
    "health_monitor_errors_total",
    "heartbeat-round exceptions, by region (region=\"_round\" for "
    "whole-round failures that would otherwise be swallowed)")
_STALE_OWNER_RETRIES = registry.counter(
    "cluster_stale_owner_retries_total",
    "routed retries after a 409 stale-owner answer mid-failover")

# sentinel: a stale-owner retry that produced no result (the region
# stays in the partial answer's missing set)
_GATHER_MISS = object()


@dataclass
class GatherMeta:
    """Outcome marker for a degraded scatter-gather: which routed
    regions contributed nothing and why.  `partial` is the wire-level
    `partial: true` flag the server surfaces on /query* responses."""

    partial: bool = False
    missing_regions: list[int] = field(default_factory=list)
    errors: dict[int, str] = field(default_factory=dict)


class Cluster:
    def __init__(self, regions: dict[int, MetricEngine],
                 routing: RoutingTable, root_path: str, store: ObjectStore,
                 segment_ms: int, config: Optional[StorageConfig],
                 device="cuda"):
        self.regions = regions
        # the torch device every local region's engine opens on
        self.device = device
        self.routing = routing
        self._root_path = root_path
        self._store = store
        self._segment_ms = segment_ms
        self._config = config
        # heartbeat state (start_health_monitor): remote regions marked
        # dead after consecutive failed pings fail queries fast
        self._health_task: Optional[asyncio.Task] = None
        self._health_fails: dict[int, int] = {}
        # last heartbeat exception per region, surfaced via the health
        # loop's /debug/tasks backlog instead of vanishing into a bare
        # except
        self._health_errors: dict[int, dict] = {}
        self.dead_regions: set[int] = set()
        # per-remote-region circuit breakers (docs/robustness.md):
        # consecutive failures open the circuit; the health monitor's
        # pings drive open -> half-open recovery
        self.breakers: dict[int, CircuitBreaker] = {}
        self._breaker_config = BreakerConfig()
        # last load survey (survey_load): region stats + the hot-shard
        # split/rebalance plan, refreshed by the health monitor every
        # _SURVEY_EVERY rounds and surfaced on /debug/tasks
        self.rebalance_survey: Optional[dict] = None
        self._health_rounds = 0
        # ownership re-resolution hook (cluster/replication.py): when a
        # region answers 409 stale-owner mid-failover, _gather calls
        # `await owner_resolver(rid, exc)` for a fresh backend to
        # repoint at and retries ONE hop.  None = no resolver: the 409
        # degrades to a partial answer like any other region failure.
        self.owner_resolver = None

    @property
    def breaker_config(self) -> BreakerConfig:
        return self._breaker_config

    @breaker_config.setter
    def breaker_config(self, cfg: BreakerConfig) -> None:
        """Re-point EXISTING breakers too: a server that applies its
        [breaker] section after remote regions were attached must not
        leave them on the defaults (order-independent configuration)."""
        self._breaker_config = cfg
        for br in self.breakers.values():
            br.config = cfg

    @classmethod
    async def open(cls, root_path: str, store: ObjectStore,
                   num_regions: int = 2,
                   segment_ms: int = 2 * 3600 * 1000,
                   config: Optional[StorageConfig] = None,
                   routing: Optional[RoutingTable] = None,
                   serve: Optional[set] = None,
                   device="cuda") -> "Cluster":
        """`serve` limits which regions get LOCAL engines (default: all
        in the routing table).  A node joining an existing cluster must
        pass the set it owns — opening a region another node is serving
        would race its manifest merger.  Every local engine opens on
        `device` ("cuda" by default; raises without a card)."""
        from horaedb_tpu_torch.objstore import NotFoundError

        if routing is None:
            # the persisted routing table (the cluster's "root table"
            # state) wins over a fresh uniform layout
            try:
                routing = RoutingTable.from_json(
                    (await store.get(f"{root_path}/routing.json")).decode())
            except NotFoundError:
                routing = RoutingTable.uniform(list(range(num_regions)))
        regions = {}
        for rid in routing.region_ids():
            if serve is not None and rid not in serve:
                continue
            regions[rid] = await MetricEngine.open(
                f"{root_path}/region_{rid}", store, segment_ms=segment_ms,
                config=config, device=device)
        return cls(regions, routing, root_path, store, segment_ms, config,
                   device=device)

    async def save_routing(self) -> None:
        """Persist the routing table (atomic object-store put)."""
        await self._store.put(f"{self._root_path}/routing.json",
                              self.routing.to_json().encode())

    async def split_region(self, region_id: int, pivot_key: int,
                           new_region_id: int, table_ttl_ms: int) -> None:
        """The full split flow, ordered so a failure at any step leaves a
        consistent cluster: (1) provision the new region, (2) build and
        PERSIST the new routing on a copy, (3) swap it live.  Writes
        route to the new region only after the durable routing exists —
        a crash mid-split can orphan an empty region directory, never
        lose a routed write."""

        await self.add_region(new_region_id)
        new_routing = RoutingTable(rules=list(self.routing.rules),
                                   strict_time_routing=self.routing
                                   .strict_time_routing)
        new_routing.split(region_id, pivot_key, new_region_id,
                          now_ms(), table_ttl_ms)
        await self._store.put(f"{self._root_path}/routing.json",
                              new_routing.to_json().encode())
        self.routing = new_routing

    async def close(self) -> None:
        await self.stop_health_monitor()
        for e in self.regions.values():
            await e.close()

    async def add_region(self, region_id: int) -> None:
        """Provision the engine for a region created by a split; layout
        parameters come from the cluster so regions can't diverge."""
        ensure(region_id not in self.regions, f"region {region_id} exists")
        self.regions[region_id] = await MetricEngine.open(
            f"{self._root_path}/region_{region_id}", self._store,
            segment_ms=self._segment_ms, config=self._config,
            device=self.device)

    def add_remote_region(self, region_id: int, backend) -> None:
        """Attach a region served by another process (e.g. a RemoteRegion
        speaking the server's HTTP API over the network).  Attaching the first
        remote auto-starts the heartbeat monitor — dead peers must be
        discovered by the monitor, not by the first query that fans out
        to them."""
        ensure(region_id not in self.regions, f"region {region_id} exists")
        self.regions[region_id] = backend
        self._clear_dead_mark(region_id)  # fresh backend, fresh health
        self.breakers[region_id] = CircuitBreaker(str(region_id),
                                                  self.breaker_config)
        if (self._health_task is None
                and getattr(backend, "ping", None) is not None):
            try:
                self.start_health_monitor()
            except RuntimeError:
                # no running event loop (sync caller building a cluster
                # before serving): the operator starts it explicitly
                pass

    def repoint_region(self, region_id: int, backend) -> None:
        """Swap a routed region's backend in place (failover repoint:
        the old owner answered 409, the resolver found the new one).
        Health/breaker state resets — the new backend's record starts
        clean.  The OLD backend is not closed here: mid-gather its
        coroutines may still be unwinding; the caller owns its
        lifecycle."""
        ensure(region_id in self.regions,
               f"region {region_id} not attached")
        self.regions[region_id] = backend
        self._clear_dead_mark(region_id)
        if not isinstance(backend, MetricEngine):
            self.breakers[region_id] = CircuitBreaker(
                str(region_id), self.breaker_config)

    def _clear_dead_mark(self, region_id: int) -> None:
        """A region whose backend changed (adopted locally, re-attached
        remote) must not inherit a stale dead mark, failure count, or
        breaker state."""
        self.dead_regions.discard(region_id)
        self._health_fails.pop(region_id, None)
        self._health_errors.pop(region_id, None)
        self.breakers.pop(region_id, None)

    def enable_lease_routing(self, cache_ttl_ms: int = 1000,
                             backend_factory=None):
        """Wire [replication] into routing: `owner_resolver` answers
        409 stale-owner retries from the region's LIVE lease record in
        this cluster's own store/root — the same record the new
        primary's fence commits against — instead of a stubbed
        callable.  `backend_factory(record)` builds the backend for a
        resolved record; default follows the record's advertised URL
        with a RemoteRegion.  Returns the resolver (its TTL'd cache is
        inspectable in tests)."""
        from horaedb_tpu_torch.cluster.placement import LeaseOwnerResolver
        from horaedb_tpu_torch.cluster.replication import LeaseManager

        manager = LeaseManager(self._store, self._root_path)
        self.owner_resolver = LeaseOwnerResolver(
            manager, backend_factory, cache_ttl_ms=cache_ttl_ms)
        return self.owner_resolver

    # ---- region movement --------------------------------------------------

    async def detach_region(self, region_id: int) -> None:
        """Stop serving a region locally so another node can adopt it.

        The region's data lives in the SHARED object store, so moving a
        region is an ownership handoff, not a data copy: the source
        closes its engine (flushing manifests), the new owner opens one
        over the same paths.  Routing is unchanged; operations routed
        here fail loudly until a backend is re-attached
        (add_remote_region pointing at the new owner, or adopt_region
        to take it back)."""
        ensure(region_id in self.regions, f"region {region_id} not served")
        engine = self.regions.pop(region_id)
        self._clear_dead_mark(region_id)
        close = getattr(engine, "close", None)
        if close is not None:
            await close()

    async def adopt_region(self, region_id: int) -> None:
        """Take over serving a region from the shared object store —
        the destination half of a region move.  Replaces a remote proxy
        if one was attached (closing it); recovery (manifest snapshot +
        delta fold) happens in MetricEngine.open, so an owner that
        crashed without detaching cleanly is still adoptable."""
        old = self.regions.get(region_id)
        ensure(not isinstance(old, MetricEngine),
               f"region {region_id} is already served locally")
        # open FIRST: a failed open must leave any existing proxy
        # attached rather than the region backend-less
        self.regions.pop(region_id, None)
        try:
            await self.add_region(region_id)
        except BaseException:
            if old is not None:
                self.regions[region_id] = old
            raise
        # the data is served locally now; a stale dead mark (from the
        # remote proxy this replaces) must not keep failing queries
        self._clear_dead_mark(region_id)
        if old is not None:
            close = getattr(old, "close", None)
            if close is not None:
                await close()

    def region_loads(self) -> dict[int, int]:
        """Routing-rule share per served region — the cheap signal.
        `region_stats()` is the REAL load signal (rows/bytes actually
        stored); use this only when manifests are unreachable."""
        loads: dict[int, int] = {rid: 0 for rid in self.regions}
        for rule in self.routing.rules:
            if rule.region_id in loads:
                loads[rule.region_id] += 1
        return loads

    async def region_stats(self) -> dict[int, dict]:
        """Per-region data volume: {rid: {rows, bytes, rules, remote}}.
        Local regions read their manifests; remote regions are asked via
        /stats (a dead remote reports rows/bytes -1 rather than failing
        the whole survey)."""
        rules = self.region_loads()

        async def one(rid: int, backend) -> tuple[int, dict]:
            remote = not isinstance(backend, MetricEngine)
            try:
                s = await backend.stats()
                return rid, {"rows": int(s["rows"]),
                             "bytes": int(s["bytes"]),
                             "rules": rules.get(rid, 0), "remote": remote}
            except Exception:
                return rid, {"rows": -1, "bytes": -1,
                             "rules": rules.get(rid, 0), "remote": remote}

        # concurrent: the survey is bounded by ONE slow peer's timeout,
        # not the sum over unreachable peers
        results = await asyncio.gather(*(one(rid, b) for rid, b
                                         in self.regions.items()))
        return dict(results)

    # ---- health -----------------------------------------------------------

    _HEALTH_FAILS = 2

    def start_health_monitor(self, interval_s: float = 5.0) -> None:
        """Heartbeat remote regions so a dead peer is discovered by the
        monitor, not by the first query that fans out to it.  After
        _HEALTH_FAILS consecutive failed pings a region is marked dead
        and routed queries fail IMMEDIATELY with an actionable error;
        a successful ping clears the mark."""
        ensure(self._health_task is None, "health monitor already running")
        self._health_task = loops.spawn(
            lambda hb: self._health_loop(hb, interval_s),
            name="health-monitor", owner="cluster",
            period_s=interval_s, backlog=self._health_backlog)

    def _health_backlog(self) -> dict:
        """/debug/tasks hint: which peers are failing and the last
        heartbeat error per region (with its timestamp)."""
        out = {
            "dead_regions": sorted(self.dead_regions),
            "consecutive_fails": {str(r): n for r, n
                                  in self._health_fails.items() if n},
            "last_errors": {str(r): dict(e) for r, e
                            in self._health_errors.items()},
        }
        if self.rebalance_survey is not None:
            # the hot-shard signal rides the same surface: an operator
            # watching /debug/tasks sees the split/rebalance plan next
            # to the liveness it derives from
            out["rebalance"] = {
                "at_ms": self.rebalance_survey["at_ms"],
                "plan": self.rebalance_survey["plan"],
            }
        return out

    async def stop_health_monitor(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            try:
                await self._health_task
            except asyncio.CancelledError:
                pass
            self._health_task = None

    async def check_health_once(self) -> dict[int, bool]:
        """One heartbeat round (the monitor's body; callable directly in
        tests/ops tooling).  Returns {rid: alive} for remote regions.
        Pings run CONCURRENTLY so a round is bounded by one ping
        timeout, not the sum over sick peers."""
        targets = [(rid, ping) for rid, backend in self.regions.items()
                   if (ping := getattr(backend, "ping", None)) is not None]
        # return_exceptions: one ping RAISING (vs. returning False) used
        # to kill the whole round — and the loop's bare except then
        # swallowed it, so a buggy backend was indistinguishable from a
        # healthy idle monitor.  Now it counts, is surfaced, and marks
        # only ITS region failed.
        results = await asyncio.gather(*(p() for _rid, p in targets),
                                       return_exceptions=True)
        alive: dict[int, bool] = {}
        for (rid, _p), res in zip(targets, results):
            if isinstance(res, asyncio.CancelledError):
                raise res
            if isinstance(res, BaseException):
                _HEALTH_ERRORS.labels(region=str(rid)).inc()
                self._health_errors[rid] = {
                    "error": str(res) or type(res).__name__,
                    "at_ms": now_ms()}
                logger.warning("health ping for region %s raised: %s",
                               rid, res)
                ok = False
            else:
                ok = bool(res)
            alive[rid] = ok
            br = self.breakers.get(rid)
            if ok:
                self._health_fails[rid] = 0
                self.dead_regions.discard(rid)
                if br is not None:
                    # open circuits move to half-open on a good ping:
                    # the next real query is the recovery probe
                    br.on_ping_ok()
            else:
                self._health_fails[rid] = self._health_fails.get(rid, 0) + 1
                if self._health_fails[rid] >= self._HEALTH_FAILS:
                    self.dead_regions.add(rid)
                if br is not None:
                    # a dead peer opens its circuit even without query
                    # traffic, so the first query after an outage skips
                    # it instead of paying a connect timeout
                    br.record_failure()
        return alive

    # load surveys (region_stats RPCs to every peer) are heavier than
    # pings: refresh the rebalance plan every Nth health round
    _SURVEY_EVERY = 6

    async def _health_loop(self, hb, interval_s: float) -> None:
        while True:
            hb.beat()
            try:
                # each round is an op trace: ping RPC spans + failure
                # attribution land in /debug/traces?kind=op
                with op_trace("health_round", slow_s=max(interval_s,
                                                         5.0)):
                    await self.check_health_once()
                    self._health_rounds += 1
                    if self._health_rounds % self._SURVEY_EVERY == 0:
                        # per-region load -> hot-shard split/rebalance
                        # recommendation (cached; /debug/tasks +
                        # /admin/rebalance read it)
                        await self.survey_load()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — a crash must not
                # kill the loop, but it must not vanish either: count
                # it and surface it on /debug/tasks (last_error)
                hb.error(exc)
                _HEALTH_ERRORS.labels(region="_round").inc()
                logger.exception("health-monitor round failed")
            await asyncio.sleep(interval_s)

    # ---- rebalancing ------------------------------------------------------

    async def propose_rebalance(self, skew_ratio: float = 2.0
                                ) -> list[dict]:
        """Propose region moves from the REAL load signal: regions whose
        stored bytes exceed `skew_ratio` x the mean are flagged with the
        detach/adopt recipe (ownership handoff over the shared store —
        no data copy) plus a split recipe when the hot region serves
        several routing rules (a hot SHARD is relieved by splitting its
        key range, not by moving the whole thing to an equally-sized
        victim).  Returns [] when balanced.  The operator (or an
        external controller loop) executes the moves; this node cannot
        know its peers' capacities."""
        return self._rebalance_from_stats(await self.region_stats(),
                                          skew_ratio)

    def split_pivot(self, region_id: int) -> Optional[int]:
        """Machine-executable split point for a hot region: the
        midpoint of its WIDEST live routing rule (without per-key load
        stats, halving the largest key share is the best static
        guess).  None when the region has no splittable rule."""
        best = None
        for rule in self.routing.rules:
            if rule.region_id != region_id:
                continue
            if rule.end_key - rule.start_key < 2:
                continue
            if best is None or (rule.end_key - rule.start_key
                                > best.end_key - best.start_key):
                best = rule
        if best is None:
            return None
        return best.start_key + (best.end_key - best.start_key) // 2

    def _rebalance_from_stats(self, stats: dict[int, dict],
                              skew_ratio: float) -> list[dict]:
        sized = {rid: s["bytes"] for rid, s in stats.items()
                 if s["bytes"] >= 0}
        if len(sized) < 2:
            return []
        mean = sum(sized.values()) / len(sized)
        if mean <= 0:
            return []
        next_rid = max(list(sized) + [r.region_id
                       for r in self.routing.rules]) + 1
        plan = []
        for rid, b in sorted(sized.items(), key=lambda kv: -kv[1]):
            if b > skew_ratio * mean:
                rules = stats[rid].get("rules", 0)
                entry = {
                    "region": rid,
                    "kind": "move",
                    "bytes": b,
                    "mean_bytes": round(mean),
                    "rules": rules,
                    "reason": f"stores {b / mean:.1f}x the mean",
                    "proposal": ("detach_region({rid}) here; "
                                 "adopt_region({rid}) on a lighter node"
                                 .format(rid=rid)),
                }
                pivot = self.split_pivot(rid) if rules >= 1 else None
                if pivot is not None:
                    # hot shard: halve its key share in place; the new
                    # region can then move independently.  pivot_key +
                    # new_region_id make the entry machine-executable
                    # (cluster/replication.py RebalanceExecutor) —
                    # split_region(region, pivot_key, new_region_id,
                    # table_ttl_ms) runs it verbatim.
                    entry["kind"] = "split"
                    entry["pivot_key"] = pivot
                    entry["new_region_id"] = next_rid
                    entry["split_proposal"] = (
                        f"split_region({rid}, pivot_key={pivot}, "
                        f"new_region_id={next_rid}, "
                        "table_ttl_ms=<table TTL>)")
                    next_rid += 1
                plan.append(entry)
        return plan

    async def survey_load(self, skew_ratio: float = 2.0) -> dict:
        """One load survey: per-region rows/bytes plus the rebalance/
        split plan, cached for /debug/tasks (the health monitor runs
        this periodically) and served by POST /admin/rebalance."""
        stats = await self.region_stats()
        out = {
            "at_ms": now_ms(),
            "skew_ratio": skew_ratio,
            "region_stats": {str(r): s for r, s in sorted(stats.items())},
            "plan": self._rebalance_from_stats(stats, skew_ratio),
        }
        self.rebalance_survey = out
        return out

    # ---- write ------------------------------------------------------------

    async def write(self, samples: list[Sample]) -> None:
        now = now_ms()
        by_region: dict[int, list[Sample]] = {}
        for s in samples:
            rid = self.routing.route_write(
                routing_key(s.name, s.labels), now)
            by_region.setdefault(rid, []).append(s)
        # validate every target BEFORE writing anything: a region created
        # by split() must be provisioned via add_region() first, and a
        # partial multi-region write would be hard to unwind
        missing = [rid for rid in by_region if rid not in self.regions]
        ensure(not missing,
               f"routing targets unprovisioned regions {missing}; call "
               "add_region() after split()")
        dead = [rid for rid in by_region if rid in self.dead_regions]
        ensure(not dead,
               f"write routes to DEAD remote regions {dead} (heartbeat "
               "failing) — failing BEFORE any region commits so a retry "
               "cannot duplicate rows; restore the peer or move the "
               "region (adopt_region / add_remote_region)")
        await asyncio.gather(*(
            self.regions[rid].write(batch)
            for rid, batch in by_region.items()))

    # ---- read (scatter-gather) --------------------------------------------

    def _query_regions(self, metric: str, filters: list[tuple[str, str]],
                       time_range: TimeRange) -> list[int]:
        # a query pins to one key only if the filters form a full series
        # key, which we can't know without the schema — so fan out to all
        # rules alive for the window (RFC accepts full-region scatter).
        # Every routed region must have an attached backend: silently
        # skipping one (e.g. detached mid-move) would return PARTIAL
        # data with no indication.
        rids = self.routing.route_query(None, int(time_range.start),
                                        int(time_range.end))
        missing = [rid for rid in rids if rid not in self.regions]
        ensure(not missing,
               f"query routes to regions {missing} with no attached "
               "backend (moved/detached?); attach via add_remote_region "
               "or adopt_region")
        dead = [rid for rid in rids if rid in self.dead_regions]
        ensure(not dead,
               f"query routes to DEAD remote regions {dead} (heartbeat "
               "failing); restore the peer, or move the region here with "
               "adopt_region / to another node with add_remote_region")
        return rids

    async def query(self, metric: str, filters: list[tuple[str, str]],
                    time_range: TimeRange, field: str = "value") -> pa.Table:
        rids = self._query_regions(metric, filters, time_range)
        tables = await asyncio.gather(*(
            self.regions[rid].query(metric, filters, time_range, field=field)
            for rid in rids))
        # all regions share one result schema, so concat handles the
        # empty case too — no refetch needed
        return pa.concat_tables(tables)

    async def query_downsample(self, metric: str,
                               filters: list[tuple[str, str]],
                               time_range: TimeRange, bucket_ms: int,
                               field: str = "value") -> dict:
        """Scatter-gather downsample: per-region grids merged by tsid.
        Regions are series-disjoint in steady state; during a split's TTL
        window an overlapping tsid combines additively (sum/count/min/
        max; avg recomputed; `last` takes the later region's value)."""
        rids = self._query_regions(metric, filters, time_range)
        results = await asyncio.gather(*(
            self.regions[rid].query_downsample(metric, filters, time_range,
                                               bucket_ms, field=field)
            for rid in rids))
        return _merge_downsample(results, time_range, bucket_ms)

    async def label_values(self, metric: str, tag_key: str,
                           time_range: TimeRange) -> list[str]:
        rids = self._query_regions(metric, [], time_range)
        results = await asyncio.gather(*(
            self.regions[rid].label_values(metric, tag_key, time_range)
            for rid in rids))
        out: set[str] = set()
        for r in results:
            out.update(r)
        return sorted(out)

    # ---- degraded read (resilient scatter-gather) -------------------------
    #
    # The strict methods above fail the whole query when any routed
    # region is unreachable — correct for consistency-sensitive
    # callers, wrong for a serving path where one slow or dead region
    # must not take down every dashboard.  The *_gather variants
    # return the SURVIVING regions' data plus a GatherMeta marker
    # (partial / missing_regions) instead:
    #
    #   * dead regions (heartbeat) and open-circuit regions are
    #     skipped up front — no connect attempt, no timeout wait;
    #   * every remote attempt is bounded by
    #     min(breaker.rpc_timeout, ambient deadline remaining);
    #   * failures and timeouts get ONE bounded retry (reads are
    #     idempotent), breaker bookkeeping on every outcome;
    #   * optional hedged reads: after hedge_delay with no response a
    #     second identical request races the first.

    def breaker_states(self) -> dict[int, str]:
        """Per-region breaker state (ops/debug surface)."""
        return {rid: br.state for rid, br in self.breakers.items()}

    def _gather_targets(self, time_range: TimeRange
                        ) -> tuple[list[int], dict[int, str]]:
        """Split routed regions into live targets and skipped ones
        (with reasons).  Unlike _query_regions, nothing raises."""
        rids = self.routing.route_query(None, int(time_range.start),
                                        int(time_range.end))
        live: list[int] = []
        skipped: dict[int, str] = {}
        for rid in rids:
            if rid not in self.regions:
                skipped[rid] = "no attached backend (moved/detached?)"
            elif rid in self.dead_regions:
                skipped[rid] = "dead (heartbeat failing)"
            else:
                br = self.breakers.get(rid)
                if br is not None and not br.allow():
                    skipped[rid] = "circuit open"
                else:
                    live.append(rid)
        return live, skipped

    async def _call_region(self, rid: int, factory):
        """One region's read RPC under the resilience policy.  `factory`
        builds a fresh coroutine per attempt (retries and hedges need
        independent coroutines)."""
        backend = self.regions[rid]
        br = self.breakers.get(rid)
        if isinstance(backend, MetricEngine):
            # local engines are bounded by the deadline checkpoints in
            # the storage read path, not by an RPC timeout.  The span
            # keeps gather traces region-attributed either way (a
            # remote backend's RPC span nests under this one).
            with span("region_call", region=rid, local=True):
                return await factory()
        cfg = self.breaker_config
        cap = cfg.rpc_timeout.seconds or None
        attempts = 1 + max(0, cfg.retries)
        try:
            with span("region_call", region=rid, local=False):
                return await self._call_region_attempts(rid, factory, br,
                                                        cap, attempts)
        except (asyncio.CancelledError, deadline_mod.DeadlineExceeded):
            # exits that record NO outcome must still release a
            # half-open probe slot this call may have claimed, or the
            # breaker wedges rejecting until the next good ping
            if br is not None:
                br.abort_probe()
            raise

    async def _call_region_attempts(self, rid, factory, br,
                                    cap: Optional[float], attempts: int):
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            budget = deadline_mod.remaining_budget(cap)
            if budget is not None and budget <= 0.001:
                # the REQUEST ran out of time — not the region's fault,
                # so no breaker failure is recorded
                raise deadline_mod.DeadlineExceeded(
                    f"region {rid}: no deadline budget left")
            # when the deadline (not rpc_timeout) is what bounds this
            # attempt, a timeout is the requester's deadline expiring —
            # charging it to the region would open circuits on healthy
            # peers whenever clients send tight deadlines
            deadline_limited = (budget is not None
                                and (cap is None or budget < cap))
            if attempt:
                _RPC_RETRIES.inc()
            try:
                result = await self._hedged_attempt(factory, budget)
                if br is not None:
                    br.record_success()
                return result
            except asyncio.CancelledError:
                raise
            except deadline_mod.DeadlineExceeded:
                raise  # requester's deadline: no breaker bookkeeping
            except asyncio.TimeoutError:
                if deadline_limited:
                    raise deadline_mod.DeadlineExceeded(
                        f"region {rid}: request deadline expired "
                        "mid-RPC")
                _RPC_TIMEOUTS.inc()
                if br is not None:
                    br.record_failure()
                shown = "unbounded" if budget is None else f"{budget:.3f}s"
                last_exc = Error(
                    f"region {rid} RPC timed out (budget {shown})")
            except Exception as exc:
                if br is not None:
                    br.record_failure()
                last_exc = exc
            # the failure may have opened (or re-opened) the circuit:
            # retrying into an open breaker is exactly the load
            # multiplication it exists to prevent.  state (pure read)
            # rather than allow(): allow() on a cooled-down breaker
            # would CLAIM the half-open probe slot we are not about to
            # use
            if br is not None and br.state != BREAKER_CLOSED:
                break
        assert last_exc is not None
        raise last_exc

    async def _hedged_attempt(self, factory, budget: Optional[float]):
        """One policy attempt, optionally hedged: if the primary has
        not answered within hedge_delay, fire a second identical
        request and take whichever SUCCEEDS first.  Reads only —
        callers guarantee idempotency."""
        delay = self.breaker_config.hedge_delay.seconds
        if delay <= 0 or (budget is not None and delay >= budget):
            return await asyncio.wait_for(factory(), budget)
        primary = asyncio.ensure_future(factory())
        tasks = [primary]
        try:
            done, _ = await asyncio.wait({primary}, timeout=delay)
            if done:
                return primary.result()  # raises the primary's error
            _HEDGES.inc()
            hedge = asyncio.ensure_future(factory())
            tasks.append(hedge)
            end = (None if budget is None
                   else time.monotonic() + (budget - delay))
            pending = set(tasks)
            last_exc: Optional[BaseException] = None
            while pending:
                step = (None if end is None
                        else max(0.0, end - time.monotonic()))
                done, pending = await asyncio.wait(
                    pending, timeout=step,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    raise asyncio.TimeoutError()
                for t in done:
                    if t.exception() is None:
                        if t is not primary:
                            _HEDGE_WINS.inc()
                        return t.result()
                    last_exc = t.exception()
            assert last_exc is not None
            raise last_exc
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
                elif not t.cancelled():
                    # retrieve a loser's error so asyncio never logs
                    # "Task exception was never retrieved" for the
                    # attempt that lost the race
                    t.exception()

    async def _retry_stale_owner(self, rid: int, exc, factory_for):
        """One routed retry after a 409 stale-owner answer: ask the
        resolver for the region's new backend, repoint, re-issue the
        region call.  Any failure — no resolver, resolver error, no
        backend, retry failure — returns _GATHER_MISS and the region
        degrades to a partial answer (X-Missing-Regions), never a hard
        error to the client."""
        if self.owner_resolver is None:
            return _GATHER_MISS
        try:
            backend = await self.owner_resolver(rid, exc)
        except Exception as res_exc:  # noqa: BLE001 — degrade, not fail
            logger.warning("gather: owner re-resolution for region %s "
                           "failed: %s", rid, res_exc)
            return _GATHER_MISS
        if backend is None:
            return _GATHER_MISS
        _STALE_OWNER_RETRIES.inc()
        self.repoint_region(rid, backend)
        try:
            return await self._call_region(rid, factory_for(rid))
        except asyncio.CancelledError:
            raise
        except Exception as retry_exc:  # noqa: BLE001 — one hop only
            logger.warning("gather: stale-owner retry for region %s "
                           "failed: %s", rid, retry_exc)
            return _GATHER_MISS

    async def _gather(self, time_range: TimeRange, factory_for
                      ) -> tuple[dict[int, object], GatherMeta]:
        """Degraded scatter-gather core: returns {rid: result} for the
        regions that answered plus the GatherMeta marker.  Raises only
        when EVERY routed region failed or was skipped — a query that
        can return no region's data at all has nothing to degrade to."""
        from horaedb_tpu_torch.cluster.replication import StaleOwnerError

        live, skipped = self._gather_targets(time_range)
        outcomes = await asyncio.gather(
            *(self._call_region(rid, factory_for(rid)) for rid in live),
            return_exceptions=True)
        results: dict[int, object] = {}
        errors: dict[int, str] = dict(skipped)
        stale: dict[int, StaleOwnerError] = {}
        for rid, out in zip(live, outcomes):
            if isinstance(out, asyncio.CancelledError):
                raise out
            if isinstance(out, StaleOwnerError):
                # mid-failover 409: never a hard error — try ONE
                # routed retry against the re-resolved owner below,
                # else degrade to a partial answer
                stale[rid] = out
                errors[rid] = str(out) or "stale owner"
            elif isinstance(out, BaseException):
                logger.warning("gather: region %s failed: %s", rid, out)
                errors[rid] = str(out) or type(out).__name__
            else:
                results[rid] = out
        for rid, exc in stale.items():
            retried = await self._retry_stale_owner(rid, exc, factory_for)
            if retried is not _GATHER_MISS:
                results[rid] = retried
                errors.pop(rid, None)
        missing = sorted(set(errors))
        if not results:
            dl = deadline_mod.current_deadline()
            if dl is not None and dl.expired:
                # every region "failed" because the request ran out of
                # time — that is a deadline outcome (HTTP 504), not a
                # region failure (400)
                raise deadline_mod.DeadlineExceeded(
                    "query deadline expired before any region answered: "
                    f"{errors}")
            raise Error(f"query failed in every routed region: {errors}")
        if missing:
            _GATHER_PARTIAL.inc()
        meta = GatherMeta(partial=bool(missing), missing_regions=missing,
                          errors=errors)
        return results, meta

    async def query_gather(self, metric: str,
                           filters: list[tuple[str, str]],
                           time_range: TimeRange, field: str = "value"
                           ) -> tuple[pa.Table, GatherMeta]:
        """Degraded row scatter-gather: surviving regions' rows plus
        the partial/missing_regions marker."""
        results, meta = await self._gather(
            time_range,
            lambda rid: lambda: self.regions[rid].query(
                metric, filters, time_range, field=field))
        return pa.concat_tables(list(results.values())), meta

    async def query_downsample_gather(self, metric: str,
                                      filters: list[tuple[str, str]],
                                      time_range: TimeRange,
                                      bucket_ms: int,
                                      field: str = "value"
                                      ) -> tuple[dict, GatherMeta]:
        """Degraded downsample scatter-gather (same per-tsid merge as
        the strict path)."""
        results, meta = await self._gather(
            time_range,
            lambda rid: lambda: self.regions[rid].query_downsample(
                metric, filters, time_range, bucket_ms, field=field))
        return (_merge_downsample(list(results.values()), time_range,
                                  bucket_ms), meta)

    async def label_values_gather(self, metric: str, tag_key: str,
                                  time_range: TimeRange
                                  ) -> tuple[list[str], GatherMeta]:
        """Degraded label-value union across surviving regions."""
        results, meta = await self._gather(
            time_range,
            lambda rid: lambda: self.regions[rid].label_values(
                metric, tag_key, time_range))
        out: set[str] = set()
        for vals in results.values():
            out.update(vals)
        return sorted(out), meta


def _merge_downsample(results: list[dict], time_range: TimeRange,
                      bucket_ms: int) -> dict:
    """Merge per-region downsample grids by tsid (shared by the strict
    and degraded gather paths).  Delegates to the combine module's
    cross-region merge, which allocates only the aggregates the regions
    actually returned — a subset query no longer pays six full
    groups x buckets grids at the coordinator."""
    from horaedb_tpu_torch.common.ipc import host_downsample
    from horaedb_tpu_torch.storage.combine import merge_downsample_results

    # a local region's fused route hands back device tensors: the merge
    # is a host fold over numpy grids
    results = [host_downsample(r) for r in results]
    num_buckets = -(-(int(time_range.end) - int(time_range.start))
                    // bucket_ms)
    return merge_downsample_results(results, num_buckets)
