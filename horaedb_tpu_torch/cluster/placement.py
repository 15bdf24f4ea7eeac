"""Closed placement loop: ONE controller owns follower placement,
promotion choice, and region moves.

On their own, the RebalanceExecutor records `no_target` for
whole-region moves and treats replica health as vacuously true, and
`Cluster.owner_resolver` is None.  This module closes those seams:

  * `PlacementController` is fed by the cluster's manifests
    (region_stats / rebalance_survey) and by `replication_lag_seqs`
    probes (each region's WalFollower.lag), and implements the
    executor's `replica_healthy` / `move_target` hooks plus the
    promotion-choice seam (`choose_promotion` / `promote_region`).
    Every decision — refusals included — lands in a bounded history
    surfaced on /debug/tasks through the controller's heartbeated
    loop.
  * `LeaseOwnerResolver` is the `Cluster.owner_resolver` that answers
    from LIVE lease records in the shared store (with a small TTL'd
    cache), so the 409 stale-owner routed retry follows real
    failovers instead of test stubs.

The controller never invents authority: promotion still goes through
`promote()` (the lease's monotonic-epoch acquire), moves still flow
through the executor's safety envelope, and routing still answers
from the lease records every fence already trusts.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.time_ext import now_ms
from horaedb_tpu_torch.cluster.replication import (LeaseManager, LeaseRecord,
                                             RebalanceConfig)

logger = logging.getLogger(__name__)


class LeaseOwnerResolver:
    """`Cluster.owner_resolver` backed by the region's lease record.

    On a 409 stale-owner the gather path asks for a fresh backend;
    this resolver reads the CURRENT lease record (the same record the
    winner's fence commits against) and maps it to a backend — via the
    record's advertised `url` (RemoteRegion over HTTP) or a caller
    `backend_factory` for in-process topologies.  Resolutions are
    cached for `cache_ttl_ms` so a 409 storm during an election costs
    one store read per region per TTL, not one per failed request; a
    409 whose owner hint contradicts the cached record busts the cache
    (the record moved under us mid-TTL).

    Returns None — degrading the gather to a partial answer — when no
    live lease exists: mid-election there IS no owner to route to.
    """

    def __init__(self, lease_manager: LeaseManager,
                 backend_factory: Optional[
                     Callable[[LeaseRecord], object]] = None,
                 cache_ttl_ms: int = 1000,
                 clock: Callable[[], int] = now_ms):
        self.lease_manager = lease_manager
        self.backend_factory = backend_factory
        self.cache_ttl_ms = cache_ttl_ms
        self._clock = clock
        # region -> (resolved_at_ms, record, backend)
        self._cache: dict[int, tuple[int, LeaseRecord, object]] = {}

    async def __call__(self, region_id: int, exc) -> Optional[object]:
        now = self._clock()
        hint = getattr(exc, "owner", None)
        hit = self._cache.get(region_id)
        if hit is not None:
            at, rec, backend = hit
            stale = now - at > self.cache_ttl_ms
            contradicted = bool(hint) and hint not in (rec.url,
                                                       rec.holder)
            if not stale and not contradicted:
                return backend
        rec = await self.lease_manager.read(region_id)
        if (rec is None or not rec.holder
                or rec.expires_at_ms <= now):
            return None
        backend = self._make_backend(rec)
        if backend is not None:
            self._cache[region_id] = (now, rec, backend)
        return backend

    def _make_backend(self, rec: LeaseRecord) -> Optional[object]:
        if self.backend_factory is not None:
            return self.backend_factory(rec)
        if rec.url:
            from horaedb_tpu_torch.cluster.remote import RemoteRegion

            return RemoteRegion(rec.url)
        return None


class PlacementController:
    """The single decision-maker for where regions live and who serves
    them.  It does not move data itself: it answers the executor's
    questions (is the replica healthy? where should this region go?)
    and, when asked to fail a region over, picks the freshest
    registered standby — so every placement decision has one owner and
    one audit trail.

    Wiring:
      controller.attach(executor)        # replica_healthy + move_target
      controller.register_follower(rid, follower)   # lag probe
      controller.register_standby(rid, holder, fitness, promote_cb)
      controller.register_node(node, adopt, load)   # move destinations
      controller.start()                 # the observing loop
    """

    _HISTORY = 64

    def __init__(self, cluster,
                 config: Optional[RebalanceConfig] = None,
                 clock: Callable[[], int] = now_ms):
        self.cluster = cluster
        self.config = config or RebalanceConfig()
        self._clock = clock
        # region -> replication lag probe (WalFollower.lag or peer
        # /repl/status reading) — the replica_healthy signal
        self._lag_probes: dict[int, Callable[[], int]] = {}
        # region -> {holder -> {"fitness": () -> int,
        #                       "promote": async () -> (engine, lease)}}
        self._standbys: dict[int, dict[str, dict]] = {}
        # node_id -> {"adopt": async (rid, entry) -> bool,
        #             "load": () -> int}
        self._nodes: dict[str, dict] = {}
        self.history: list[dict] = []
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # refreshed each loop tick from manifests + lag probes
        self.snapshot: dict = {}

    # ---- registration ------------------------------------------------------

    def register_follower(self, region_id: int, follower) -> None:
        """Feed a region's `replication_lag_seqs` from a local
        WalFollower (the common case)."""
        self.register_lag_probe(region_id, follower.lag)

    def register_lag_probe(self, region_id: int,
                           probe: Callable[[], int]) -> None:
        self._lag_probes[region_id] = probe

    def register_standby(self, region_id: int, holder: str,
                         fitness: Callable[[], int],
                         promote: Callable[[], Awaitable]) -> None:
        """A candidate for promotion: `fitness` returns its mirrored
        watermark, `promote` performs its lease-acquiring takeover."""
        self._standbys.setdefault(region_id, {})[holder] = {
            "fitness": fitness, "promote": promote}

    def register_node(self, node_id: str,
                      adopt: Callable[[int, dict], Awaitable[bool]],
                      load: Optional[Callable[[], int]] = None) -> None:
        """A move destination: `adopt` takes (region_id, plan entry)
        and returns True once the node serves the region; `load` ranks
        candidates (lower = preferred)."""
        self._nodes[node_id] = {"adopt": adopt,
                                "load": load or (lambda: 0)}

    def attach(self, executor) -> None:
        """Close the executor's open seams: placement decisions now
        come from this controller."""
        executor.replica_healthy = self.replica_healthy
        executor.move_target = self.move_target

    # ---- decision history --------------------------------------------------

    def _record(self, kind: str, outcome: str, region=None,
                detail: str = "") -> dict:
        rec = {"kind": kind, "outcome": outcome,
               "at_ms": self._clock()}
        if region is not None:
            rec["region"] = region
        if detail:
            rec["detail"] = detail
        self.history.append(rec)
        del self.history[:-self._HISTORY]
        return rec

    # ---- the executor's seams ----------------------------------------------

    def replica_healthy(self, region_id: int) -> bool:
        """Is the region safe to move/split — i.e. would its replica
        survive losing the primary mid-operation?  A region with no
        lag probe has no replica wired: vacuously healthy, matching
        the executor's pre-controller behavior.  Refusals are recorded
        (healthy checks are too chatty to log)."""
        probe = self._lag_probes.get(region_id)
        if probe is None:
            return True
        lag = probe()
        if lag <= self.config.max_replica_lag_seqs:
            return True
        self._record("replica_check", "unhealthy", region=region_id,
                     detail=f"lag {lag} seqs")
        return False

    async def move_target(self, region_id: int, entry: dict) -> bool:
        """Execute a whole-region move: pick the least-loaded
        registered node and ask it to adopt the region (ownership
        handoff over the shared store — no data copy).  Declining
        nodes are skipped; no willing node means no move."""
        cands = sorted(self._nodes.items(),
                       key=lambda kv: kv[1]["load"]())
        for node_id, node in cands:
            try:
                adopted = await node["adopt"](region_id, entry)
            except Exception as exc:  # noqa: BLE001 — counted, and the
                # next candidate is tried; all-declined records no_target
                self._record("move", "error", region=region_id,
                             detail=f"{node_id}: {exc}")
                continue
            if adopted:
                self._record("move", "executed", region=region_id,
                             detail=f"-> {node_id}")
                return True
        self._record("move", "no_target", region=region_id,
                     detail=f"{len(cands)} candidates declined")
        return False

    # ---- promotion choice --------------------------------------------------

    def choose_promotion(self, region_id: int) -> Optional[str]:
        """The standby that should take over `region_id`: freshest
        mirror (highest fitness) wins, ties broken by holder name for
        determinism.  None when no standby is registered."""
        best: Optional[str] = None
        best_fit = -1
        for holder in sorted(self._standbys.get(region_id, {})):
            fit = self._standbys[region_id][holder]["fitness"]()
            if fit > best_fit:
                best, best_fit = holder, fit
        return best

    async def promote_region(self, region_id: int):
        """Operator/controller-initiated failover: promote the chosen
        standby (its own `promote` callback acquires the lease — the
        election discipline holds even on the manual path).  Returns
        whatever the callback returns, or None with a recorded refusal
        when no standby exists."""
        holder = self.choose_promotion(region_id)
        if holder is None:
            self._record("promotion", "no_standby", region=region_id)
            return None
        try:
            result = await self._standbys[region_id][holder]["promote"]()
        except Exception as exc:
            self._record("promotion", "error", region=region_id,
                         detail=f"{holder}: {exc}")
            raise
        self._record("promotion", "executed", region=region_id,
                     detail=f"-> {holder}")
        return result

    # ---- the observing loop ------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> None:
        ensure(self._task is None, "placement controller already started")
        interval = (interval_s if interval_s is not None
                    else self.config.interval.seconds)
        self._task = loops.spawn(
            lambda hb: self._loop(hb, interval),
            name="placement-ctl", kind="placement", owner="cluster",
            period_s=interval,
            backlog=lambda: {"snapshot": self.snapshot,
                             "recent": self.history[-8:]})

    async def close(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self, hb, interval_s: float) -> None:
        while not self._stopping:
            await asyncio.sleep(interval_s)
            if self._stopping:
                return
            hb.beat()
            try:
                await self.refresh()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — next tick retries
                hb.error(exc)
                logger.warning("placement refresh failed: %s", exc)

    async def refresh(self) -> dict:
        """One observation pass: fold the manifest view (the health
        monitor's survey when fresh, else a direct region_stats read)
        together with the live lag probes into the snapshot that
        /debug/tasks serves — the controller's inputs are always
        inspectable next to its decisions."""
        survey = self.cluster.rebalance_survey
        if survey is not None:
            stats = survey.get("stats", {})
        else:
            stats = await self.cluster.region_stats()
        regions = {}
        for rid, s in stats.items():
            rid = int(rid)
            probe = self._lag_probes.get(rid)
            lag = probe() if probe is not None else None
            regions[rid] = {
                "bytes": s.get("bytes"),
                "rules": s.get("rules"),
                "lag_seqs": lag,
                "healthy": (lag is None
                            or lag <= self.config.max_replica_lag_seqs),
                "standbys": sorted(self._standbys.get(rid, {})),
            }
        self.snapshot = {
            "regions": regions,
            "nodes": {nid: {"load": n["load"]()}
                      for nid, n in self._nodes.items()},
            "at_ms": self._clock(),
        }
        return self.snapshot
