"""Replication plane: WAL shipping, lease-fenced ownership, failover,
and auto-executed rebalance (PAPERS.md: Taurus — separate durability
from serving, ship the log, share the pages, fence with epochs).

The design leans entirely on invariants earlier PRs already proved:

  * SSTs live in the SHARED object store and every flush commits
    through the manifest, so a follower never re-flushes — it adopts
    the primary's SSTs by opening the same region paths.  Only the
    acked-but-unflushed tail (WAL frames -> memtables) needs shipping.
  * WAL frames carry the write seq end to end, and replay dedups
    via `__seq__` last-value.  A follower therefore MIRRORS the
    primary's raw CRC-framed segment bytes into a local directory; on
    promotion, `MetricEngine.open` with the mirror as its WAL dir
    replays the tail with seqs preserved — the promoted grids are
    byte-identical with what the primary would have served, and a
    frame shipped twice is exactly-once after the merge.
  * Ownership is a lease record in the shared store with a MONOTONIC
    epoch.  Every flush on a replicated region revalidates the lease
    at the commit point (`IngestStorage.fence`, wal/ingest.py) — a
    primary whose lease was stolen gets StaleEpochError BEFORE the SST
    + manifest commit, so split-brain cannot commit.

Shipping runs over the existing aiohttp plane (`/repl/wal/*`,
`X-Deadline-Ms` / `X-Trace-Id` riding along) or in-process through
`LocalWalSource` (tests, chaos, single-process failover drills).
"""

from __future__ import annotations

import asyncio
import json
import math
import os
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

import logging

from horaedb_tpu_torch.common import deadline as deadline_mod
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.time_ext import ReadableDuration, now_ms
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.utils import registry, tracing
from horaedb_tpu_torch.wal.log import mirror_watermarks, verify_frames

logger = logging.getLogger(__name__)

# ---- metrics (label + zeroing discipline: per-region gauge children
# are REMOVED when their owner closes, so a departed region's series
# stops being scraped instead of flatlining at its last value) --------

_LAG = registry.gauge(
    "replication_lag_seqs",
    "primary WAL high-watermark minus follower shipped seq, by region")
_SHIPPED_BYTES = registry.counter(
    "replication_shipped_bytes_total",
    "WAL bytes durably mirrored by followers")
_LEASE_EPOCH = registry.gauge(
    "lease_epoch", "current lease epoch, by region (0 = released)")
_FAILOVERS = registry.counter(
    "failovers_total", "lease takeovers, by reason")
_REBALANCE_MOVES = registry.counter(
    "rebalance_moves_total",
    "auto-rebalance plan entries processed, by kind and outcome")
_ELECTIONS = registry.counter(
    "standby_elections_total",
    "standby self-promotion election attempts, by outcome")


class ReplicationError(Error):
    """A replication-plane operation failed."""


class StaleEpochError(ReplicationError):
    """The fencing refusal: this holder's lease epoch is no longer the
    region's current epoch (or its lease expired un-renewed).  Raised
    at the flush commit point — the write was NOT committed."""


class StaleOwnerError(ReplicationError):
    """The wire-level 409: the peer answered 'I no longer own this
    region'.  Carries the new owner's URL when the peer knows it, so
    the coordinator can re-resolve and retry once."""

    def __init__(self, message: str, region: Optional[int] = None,
                 owner: Optional[str] = None):
        super().__init__(message)
        self.region = region
        self.owner = owner


# ---- configuration ----------------------------------------------------------


@dataclass
class ReplicationConfig:
    """[replication]: WAL shipping + lease-fenced ownership.

    A node is a PRIMARY for its engine's regions (it serves the
    shipping endpoints and, when `region` >= 0, holds that region's
    lease and fences every flush on it).  Setting `primary_url` makes
    it ALSO a follower: it tails that peer's WAL into `mirror_dir`,
    ready to promote.
    """

    enabled: bool = False
    # lease-fenced region this node claims at startup (-1 = serve +
    # ship only, no lease)
    region: int = -1
    # lease holder identity; empty derives "server:<port>"
    holder: str = ""
    lease_ttl: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(10))
    renew_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(2))
    # follower mode: tail this peer's WAL into mirror_dir
    primary_url: str = ""
    mirror_dir: str = ""
    poll_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(500))
    # per-read-RPC byte cap for tail shipping (a transient wire chunk,
    # not a resident budget)
    max_batch_bytes: int = 4 << 20
    rpc_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(10))
    # follower liveness horizon for RETENTION: a follower silent (no
    # poll, no ack) longer than this stops pinning sealed segments — a
    # follower that died for good must not grow primary disk without
    # bound.  It is never deregistered: its next poll refreshes
    # liveness and it resyncs anything truncated meanwhile from the
    # shared SSTs (flushed_seqs) + a fresh listing.
    follower_ttl: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(60))


@dataclass
class RebalanceConfig:
    """[rebalance]: the safety envelope under which the health
    monitor's split/detach recommendations (survey_load) execute
    automatically.  Defaults are conservative: disabled, and dry-run
    even when enabled — an operator must opt in twice before the
    executor changes the routing table on its own."""

    enabled: bool = False
    # record what WOULD run without executing it
    dry_run: bool = True
    max_concurrent_moves: int = 1
    # per-region minimum gap between executed moves
    cooldown: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(300))
    # refuse to move/split a region whose replica is lagging (vacuously
    # healthy when no replica-health probe is wired)
    require_replica_healthy: bool = True
    max_replica_lag_seqs: int = 0
    skew_ratio: float = 2.0
    interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(30))
    # TTL applied to the pre-split rule (how long the old region keeps
    # answering queries for the split range)
    table_ttl_ms: int = 7 * 24 * 3600 * 1000


@dataclass
class FailoverConfig:
    """[failover]: standby self-promotion.  A follower with this on
    runs a StandbyMonitor that watches the primary's lease record and,
    once the lease sits expired past a jittered grace window, races
    `promote()` against sibling standbys — the lease's monotonic-epoch
    acquire IS the election.  Disabled by default: failover stays an
    operator/placement-controller decision unless opted in."""

    enabled: bool = False
    # how long an EXPIRED lease must stay unclaimed before this
    # standby runs an election.  The grace window absorbs a primary
    # that is slow to renew (store hiccup, GC pause) without flapping;
    # config validation refuses a grace shorter than one renewal.
    grace: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(5))
    # per-election random extra wait, as a fraction of `grace` —
    # decorrelates sibling standbys so the freshest (which also defers
    # least, see the fitness check) usually acquires uncontested
    jitter: float = 0.5
    # lease-record poll cadence for the monitor loop
    check_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(500))
    # pause between publishing our fitness record and reading the
    # siblings' — the pre-acquire "freshest mirror wins" exchange
    fitness_wait: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(200))
    # flap suppression: after a LOST or failed election this standby
    # sits out at least this long before arming another grace window
    cooldown: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(5))


# ---- lease-fenced ownership -------------------------------------------------


@dataclass
class LeaseRecord:
    region: int
    holder: str
    epoch: int
    expires_at_ms: int
    # the holder's serving address — what lease-backed routing resolves
    # a region's owner to after a failover (empty for in-process
    # holders; the resolver then needs a holder->backend factory)
    url: str = ""

    def to_json(self) -> bytes:
        return json.dumps({
            "region": self.region, "holder": self.holder,
            "epoch": self.epoch, "expires_at_ms": self.expires_at_ms,
            "url": self.url,
        }).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "LeaseRecord":
        d = json.loads(blob)
        return cls(region=int(d["region"]), holder=str(d["holder"]),
                   epoch=int(d["epoch"]),
                   expires_at_ms=int(d["expires_at_ms"]),
                   url=str(d.get("url", "")))


class LeaseManager:
    """Per-region lease records under `{root}/leases/` in the SHARED
    object store — the same store every region's manifests live in, so
    whoever can commit data can also see who owns it.

    Acquire is read-bump-put with a read-back verify: the epoch is
    strictly monotonic (a new holder's epoch is always greater than
    every epoch that ever committed), and a racing acquirer that
    overwrote our record between put and read-back wins — we fail.
    The *commit-time* guarantee does not rest on acquire being atomic:
    every flush revalidates the record via `Lease.check()` at the
    fencing point, so a holder that lost the race can never commit.
    """

    def __init__(self, store: ObjectStore, root_path: str,
                 clock: Callable[[], int] = now_ms):
        self.store = store
        self.root_path = root_path
        self._clock = clock

    def _path(self, region: int) -> str:
        return f"{self.root_path}/leases/region_{region}.json"

    async def read(self, region: int) -> Optional[LeaseRecord]:
        try:
            blob = await self.store.get(self._path(region))
        except NotFoundError:
            return None
        return LeaseRecord.from_json(blob)

    async def acquire(self, region: int, holder: str,
                      ttl_ms: int, url: str = "") -> "Lease":
        """Take (or retake) the region's lease, bumping the epoch.
        Raises ReplicationError while another holder's lease is live."""
        now = self._clock()
        cur = await self.read(region)
        if (cur is not None and cur.holder != holder
                and cur.expires_at_ms > now):
            raise ReplicationError(
                f"region {region} lease held by {cur.holder!r} "
                f"(epoch {cur.epoch}, {cur.expires_at_ms - now}ms left)")
        epoch = (cur.epoch if cur is not None else 0) + 1
        rec = LeaseRecord(region=region, holder=holder, epoch=epoch,
                          expires_at_ms=now + ttl_ms, url=url)
        await self.store.put(self._path(region), rec.to_json())
        back = await self.read(region)
        if back is None or back.holder != holder or back.epoch != epoch:
            raise ReplicationError(
                f"region {region} lease acquire lost a race "
                f"(now held by {getattr(back, 'holder', None)!r})")
        _LEASE_EPOCH.labels(region=str(region)).set(epoch)
        logger.info("lease: %r acquired region %d at epoch %d",
                    holder, region, epoch)
        return Lease(self, rec)


class Lease:
    """One holder's live claim on a region — the FENCE object installed
    on the region's ingest tables (`IngestStorage.fence`): `check()`
    runs at every flush's commit point and raises StaleEpochError when
    this epoch is no longer the region's current one."""

    def __init__(self, manager: LeaseManager, record: LeaseRecord):
        self.manager = manager
        self.record = record
        self.lost = False
        self._renew_task: Optional[asyncio.Task] = None
        self._stopping = False
        self.on_lost: Optional[Callable[[BaseException], None]] = None

    @property
    def region(self) -> int:
        return self.record.region

    @property
    def epoch(self) -> int:
        return self.record.epoch

    def valid_locally(self) -> bool:
        """Cheap local view: not known-lost and not expired un-renewed.
        Conservative — expiry here refuses even if no one stole the
        lease yet (better to under-serve than double-commit)."""
        return (not self.lost
                and self.record.expires_at_ms > self.manager._clock())

    async def check(self) -> None:
        """The fencing read: the store's CURRENT record must still be
        (this holder, this epoch) and unexpired.  One store get per
        flush — flushes already pay an SST put + manifest commit, so
        the fence adds a small fraction, and it makes commit-time
        ownership a property of the SHARED store, not local belief."""
        if self.lost:
            raise StaleEpochError(
                f"region {self.region}: lease lost (epoch {self.epoch})")
        if not self.valid_locally():
            self.lost = True
            raise StaleEpochError(
                f"region {self.region}: lease expired un-renewed "
                f"(epoch {self.epoch})")
        cur = await self.manager.read(self.region)
        if (cur is None or cur.epoch != self.epoch
                or cur.holder != self.record.holder):
            self.lost = True
            got = "gone" if cur is None else (
                f"held by {cur.holder!r} at epoch {cur.epoch}")
            raise StaleEpochError(
                f"region {self.region}: fencing check failed — our "
                f"epoch {self.epoch}, record {got}")

    async def renew(self) -> None:
        """Extend the lease TTL; verifies the record is still ours
        first (a renewal must never resurrect a stolen lease)."""
        cur = await self.manager.read(self.region)
        if (cur is None or cur.epoch != self.epoch
                or cur.holder != self.record.holder):
            self.lost = True
            raise StaleEpochError(
                f"region {self.region}: lease stolen before renewal "
                f"(our epoch {self.epoch})")
        rec = LeaseRecord(
            region=self.region, holder=self.record.holder,
            epoch=self.epoch,
            expires_at_ms=self.manager._clock() + self._ttl_ms(),
            url=self.record.url)
        await self.manager.store.put(self.manager._path(self.region),
                                     rec.to_json())
        self.record = rec

    def _ttl_ms(self) -> int:
        # the original grant length, preserved across renewals
        return getattr(self, "_granted_ttl_ms", 10_000)

    def grant_ttl_ms(self, ttl_ms: int) -> None:
        self._granted_ttl_ms = ttl_ms

    def start_renewal(self, interval_s: float, ttl_ms: int) -> None:
        """Heartbeat loop (common/loops.py): renew every `interval_s`;
        a stolen lease stops the loop and fires `on_lost` so the owner
        can start answering 409 stale-owner."""
        ensure(self._renew_task is None, "lease renewal already running")
        self.grant_ttl_ms(ttl_ms)
        self._renew_task = loops.spawn(
            lambda hb: self._renew_loop(hb, interval_s),
            name=f"lease-renew:region_{self.region}", kind="lease-renew",
            owner="replication", period_s=interval_s,
            backlog=lambda: {"region": self.region, "epoch": self.epoch,
                             "lost": self.lost,
                             "expires_at_ms": self.record.expires_at_ms})

    async def _renew_loop(self, hb, interval_s: float) -> None:
        while not self._stopping:
            await asyncio.sleep(interval_s)
            if self._stopping:
                return
            hb.beat()
            try:
                await self.renew()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except StaleEpochError as exc:
                hb.error(exc)
                logger.warning("lease renew: %s", exc)
                if self.on_lost is not None:
                    self.on_lost(exc)
                return
            except Exception as exc:  # noqa: BLE001 — transient store
                # failure: keep trying; the lease simply expires if the
                # store stays unreachable (the conservative outcome)
                hb.error(exc)
                logger.warning("lease renew for region %d failed: %s",
                               self.region, exc)

    async def stop_renewal(self) -> None:
        self._stopping = True
        if self._renew_task is not None:
            self._renew_task.cancel()
            try:
                await self._renew_task
            except asyncio.CancelledError:
                pass
            self._renew_task = None

    async def release(self) -> None:
        """Voluntary handoff: stop renewing and, if the record is still
        ours, replace it with an already-expired TOMBSTONE that keeps
        the epoch (holder cleared, expires_at_ms=0).  Deleting instead
        would restart the next acquire at epoch 1, breaking the strict
        monotonicity every epoch consumer is promised ('always greater
        than every epoch that ever committed') — the tombstone makes a
        release/re-acquire cycle continue the sequence.  The epoch
        gauge child is removed (zeroing discipline) — a released
        region has no current holder."""
        await self.stop_renewal()
        cur = await self.manager.read(self.region)
        if (cur is not None and cur.epoch == self.epoch
                and cur.holder == self.record.holder):
            tomb = LeaseRecord(region=self.region, holder="",
                               epoch=self.epoch, expires_at_ms=0)
            await self.manager.store.put(
                self.manager._path(self.region), tomb.to_json())
        self.lost = True
        _LEASE_EPOCH.remove(region=str(self.region))


def install_fence(engine, lease: Optional[Lease]) -> None:
    """Point every WAL-fronted table of `engine` at `lease` as its
    flush-time fence (None = unfence).  The wal/ layer never imports
    cluster/ — the fence is duck-typed (`await fence.check()`)."""
    for table in engine.tables.values():
        if getattr(table, "wal", None) is not None:
            table.fence = lease


# ---- primary side: the shipping hub ----------------------------------------


class ReplicationHub:
    """Primary-side shipping surface over one engine's per-table WALs:
    segment listings, frame-aligned tail reads, follower acks, and the
    retention hook that keeps sealed segments alive until every
    registered follower acked past them.

    With no followers registered, retention defers to the WAL's
    default (always deletable) — a single-copy node behaves
    bit-for-bit as before.  Correctness does not depend on the hook:
    a segment only becomes deletable once all its seqs are flushed,
    and flushed rows live in the SHARED SSTs a follower adopts; the
    hook is what keeps the *acked high-watermark* meaningful, so a
    promotion knows exactly how fresh its mirror is.

    Retention only honors LIVE followers: one silent past
    `follower_ttl` (no poll, no ack) stops pinning segments — it
    registered on its first poll with no deregistration path, so
    without a liveness horizon a follower dead for good would block
    WAL truncation forever.  A stale follower that comes back
    refreshes its liveness on the next poll and resyncs from the
    listing + the shared-SST floor.
    """

    def __init__(self, engine, config: Optional[ReplicationConfig] = None,
                 clock: Callable[[], int] = now_ms):
        self.engine = engine
        self.config = config or ReplicationConfig()
        self._clock = clock
        self._closed = False
        # follower -> {log -> highest acked (durably mirrored) seq}
        self._acks: dict[str, dict[str, int]] = {}
        # follower -> last poll/ack wall ms (liveness for retention)
        self._last_seen: dict[str, int] = {}
        for name, wal in self._wals().items():
            wal.retention = self._retention_for(name)

    def _wals(self) -> dict:
        return {name: t.wal for name, t in self.engine.tables.items()
                if getattr(t, "wal", None) is not None}

    def _live(self, follower_id: str) -> bool:
        ttl_ms = int(self.config.follower_ttl.seconds * 1000)
        last = self._last_seen.get(follower_id, 0)
        return self._clock() - last <= ttl_ms

    def _retention_for(self, log: str):
        def allow_delete(segment_id: int, max_seq: int) -> bool:
            del segment_id
            return all(acks.get(log, 0) >= max_seq
                       for fid, acks in self._acks.items()
                       if self._live(fid))
        return allow_delete

    def register_follower(self, follower_id: str) -> None:
        self._acks.setdefault(follower_id, {})
        self._last_seen[follower_id] = self._clock()

    def ack(self, follower_id: str, acks: dict[str, int]) -> None:
        mine = self._acks.setdefault(follower_id, {})
        self._last_seen[follower_id] = self._clock()
        for log, seq in acks.items():
            mine[log] = max(mine.get(log, 0), int(seq))

    def snapshot(self, follower_id: Optional[str] = None) -> dict:
        """One poll's worth of listing state: per-log segments + high
        watermarks.  Passing `follower_id` registers the follower (its
        first poll arms retention)."""
        if self._closed:
            # a closed hub (primary dead or demoted) must REFUSE to
            # answer, matching a dead HTTP primary: an empty listing
            # would read as "everything truncated" and a tailing
            # follower would drop its whole mirror
            raise ReplicationError("replication hub closed")
        if follower_id:
            self.register_follower(follower_id)
        wals = self._wals()
        return {
            "logs": {name: wal.segments() for name, wal in wals.items()},
            "high_watermarks": {name: wal.high_watermark
                                for name, wal in wals.items()},
            # seqs at or below these are committed to shared SSTs (and
            # may already be truncated): followers count them caught up
            # without shipping
            "flushed_seqs": {name: wal.flushed_seq
                             for name, wal in wals.items()},
        }

    async def read_tail(self, log: str, segment_id: int, offset: int,
                        max_bytes: int) -> Optional[tuple[bytes, bool]]:
        if self._closed:
            raise ReplicationError("replication hub closed")
        wal = self._wals().get(log)
        if wal is None:
            raise ReplicationError(f"unknown wal log {log!r}")
        return await wal.read_tail(segment_id, offset, max_bytes)

    def status(self) -> dict:
        """/repl/status + /debug/tasks surface.  `retention_held_by`
        names the LIVE followers currently pinning otherwise-deletable
        sealed segments (fully SST-covered, un-acked, follower not yet
        past the liveness TTL) — the stuck-retention signal an
        operator greps for when primary disk grows; `stale` followers
        no longer pin anything."""
        wals = self._wals()
        hw = {name: wal.high_watermark for name, wal in wals.items()}
        flushed = {name: wal.flushed_seq for name, wal in wals.items()}
        # per log, the newest seq in a sealed + fully-flushed segment:
        # deletable but for follower acks (flushed_seq is a contiguous
        # prefix, so max_seq <= flushed_seq covers the whole segment)
        blockable = {
            name: max((s["max_seq"] for s in wal.segments()
                       if s["sealed"]
                       and s["max_seq"] <= wal.flushed_seq), default=0)
            for name, wal in wals.items()}
        followers = {}
        held_by = []
        for fid, acks in self._acks.items():
            lag = max((hw.get(log, 0) - max(acks.get(log, 0),
                                            flushed.get(log, 0))
                       for log in hw), default=0)
            live = self._live(fid)
            followers[fid] = {"acks": dict(acks), "lag_seqs": lag,
                              "stale": not live,
                              "last_seen_ms": self._last_seen.get(fid, 0)}
            if live and any(acks.get(log, 0) < m
                            for log, m in blockable.items() if m):
                held_by.append(fid)
        return {
            "high_watermarks": hw,
            "followers": followers,
            "retention_held_by": sorted(held_by),
            "follower_ttl_ms": int(
                self.config.follower_ttl.seconds * 1000),
        }

    def close(self) -> None:
        self._closed = True
        for wal in self._wals().values():
            wal.retention = None
        self._acks = {}
        self._last_seen = {}


# ---- wal sources (the follower's view of a primary) -------------------------


class LocalWalSource:
    """In-process source over a ReplicationHub — tests, chaos drills,
    and single-process multi-region failover."""

    def __init__(self, hub: ReplicationHub, follower_id: str):
        self.hub = hub
        self.follower_id = follower_id

    async def snapshot(self) -> dict:
        return self.hub.snapshot(self.follower_id)

    async def read(self, log: str, segment_id: int, offset: int,
                   max_bytes: int) -> Optional[tuple[bytes, bool]]:
        return await self.hub.read_tail(log, segment_id, offset, max_bytes)

    async def ack(self, acks: dict[str, int]) -> None:
        self.hub.ack(self.follower_id, acks)

    async def close(self) -> None:
        pass


class HttpWalSource:
    """Shipping over the existing aiohttp plane (`/repl/wal/*`).  Every
    RPC carries an explicit timeout plus the ambient deadline/trace
    headers, exactly like the cluster's region RPCs."""

    def __init__(self, base_url: str, follower_id: str,
                 timeout_s: float = 10.0, session=None):
        self.base_url = base_url.rstrip("/")
        self.follower_id = follower_id
        self.timeout_s = timeout_s
        self._session = session
        self._own_session = session is None

    async def _ensure_session(self):
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession()
        return self._session

    def _budget(self):
        import aiohttp

        dl = deadline_mod.current_deadline()
        if dl is not None:
            dl.check()
        budget = deadline_mod.remaining_budget(self.timeout_s)
        headers = {}
        if dl is not None and dl.deadline_at is not None:
            headers["X-Deadline-Ms"] = str(
                max(1, math.floor((budget or 0.0) * 1000)))
        trace = tracing.active_trace()
        if trace is not None and not trace.finished:
            headers[tracing.TRACE_HEADER] = trace.trace_id
        return aiohttp.ClientTimeout(total=budget), headers

    async def snapshot(self) -> dict:
        session = await self._ensure_session()
        timeout, headers = self._budget()
        async with session.get(
                self.base_url + "/repl/wal/segments",
                params={"follower": self.follower_id},
                timeout=timeout, headers=headers) as resp:
            if resp.status != 200:
                text = await resp.text()
                raise ReplicationError(
                    f"{self.base_url}/repl/wal/segments returned "
                    f"{resp.status}: {text[:200]}")
            return json.loads(await resp.read())

    async def read(self, log: str, segment_id: int, offset: int,
                   max_bytes: int) -> Optional[tuple[bytes, bool]]:
        session = await self._ensure_session()
        timeout, headers = self._budget()
        async with session.get(
                self.base_url + "/repl/wal/read",
                params={"log": log, "segment": str(segment_id),
                        "offset": str(offset),
                        "max_bytes": str(max_bytes)},
                timeout=timeout, headers=headers) as resp:
            if resp.status != 200:
                text = await resp.text()
                raise ReplicationError(
                    f"{self.base_url}/repl/wal/read returned "
                    f"{resp.status}: {text[:200]}")
            if resp.headers.get("X-Wal-Gone") == "1":
                return None
            sealed = resp.headers.get("X-Wal-Sealed") == "1"
            return await resp.read(), sealed

    async def ack(self, acks: dict[str, int]) -> None:
        session = await self._ensure_session()
        timeout, headers = self._budget()
        async with session.post(
                self.base_url + "/repl/wal/ack",
                json={"follower": self.follower_id, "acks": acks},
                timeout=timeout, headers=headers) as resp:
            if resp.status != 200:
                text = await resp.text()
                raise ReplicationError(
                    f"{self.base_url}/repl/wal/ack returned "
                    f"{resp.status}: {text[:200]}")

    async def close(self) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()
            self._session = None


# ---- follower: mirror the primary's WAL bytes -------------------------------


class WalFollower:
    """Tails a primary's per-table WALs into a local mirror directory,
    byte-for-byte and frame-verified.

    Mirror layout is EXACTLY the engine's WAL layout
    (`{mirror_dir}/{table}/{id:020d}.wal`), so promotion is simply
    `MetricEngine.open(..., wal dir = mirror_dir)`: the WAL's replay
    rebuilds the memtables with seqs preserved and no new replay
    machinery exists to diverge.  Each appended chunk is truncated to
    the longest verified-frame prefix (`verify_frames`) and fsynced
    before it is acked, so the primary's retention watermark only ever
    reflects DURABLY mirrored frames.
    """

    def __init__(self, source, mirror_dir: str,
                 config: Optional[ReplicationConfig] = None,
                 region: Optional[int] = None):
        self.source = source
        self.mirror_dir = mirror_dir
        self.config = config or ReplicationConfig()
        self.region = region
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # log -> {segment_id -> durably mirrored bytes}
        self._progress: dict[str, dict[int, int]] = {}
        # log -> highest seq durably mirrored
        self.shipped_seqs: dict[str, int] = {}
        self._hw: dict[str, int] = {}
        # log -> primary's SST-committed floor: seqs below it live in
        # the shared store and never need shipping
        self._flushed: dict[str, int] = {}
        self._lag_child = _LAG.labels(
            region=str(region if region is not None else "_"))
        self._lag_child.set(0)

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        ensure(self._task is None, "wal follower already started")
        interval = self.config.poll_interval.seconds
        self._task = loops.spawn(
            lambda hb: self._ship_loop(hb, interval),
            name=f"wal-ship:{self.mirror_dir}", kind="wal-ship",
            owner="replication", period_s=interval,
            backlog=lambda: {"lag_seqs": self.lag(),
                             "shipped_seqs": dict(self.shipped_seqs),
                             "high_watermarks": dict(self._hw)})

    async def close(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.source.close()
        _LAG.remove(region=str(self.region if self.region is not None
                               else "_"))

    async def retarget(self, source) -> None:
        """Point the ship loop at a NEW primary (an election loser
        falling back to tailing the winner).  The mirror is kept: its
        bytes are the old primary's stream, which the winner replayed
        from its own mirror of the same stream, so per-segment sizes
        stay valid append offsets; a divergent tail (we out-shipped
        the winner) fails frame verification on the next read and
        takes the existing resync-from-scratch path for that segment."""
        old = self.source
        self.source = source
        await old.close()

    async def _ship_loop(self, hb, interval_s: float) -> None:
        while not self._stopping:
            hb.beat()
            try:
                shipped = await self.poll_once()
                hb.ok()
                del shipped
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — the primary may
                # be mid-restart or mid-death; shipping resumes where
                # the mirror left off on the next poll
                hb.error(exc)
                logger.warning("wal shipping poll failed: %s", exc)
            await asyncio.sleep(interval_s)

    # ---- one shipping pass ------------------------------------------------

    def _mirror_path(self, log: str, segment_id: int) -> str:
        return os.path.join(self.mirror_dir, log, f"{segment_id:020d}.wal")

    def _mirrored_size(self, log: str, segment_id: int) -> int:
        known = self._progress.get(log, {}).get(segment_id)
        if known is not None:
            return known
        try:
            return os.path.getsize(self._mirror_path(log, segment_id))
        except OSError:
            return 0

    def _recover_log_blocking(self, log: str) -> tuple[dict, int]:
        """Crash-resume: rebuild per-segment progress and the shipped
        watermark from the mirror's own frames (a restarted follower
        must not report full lag over bytes it already holds).  A torn
        tail from a death mid-append is truncated so appends resume on
        a frame boundary."""
        d = os.path.join(self.mirror_dir, log)
        prog: dict[int, int] = {}
        max_seq = 0
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return prog, max_seq
        for name in names:
            if not name.endswith(".wal"):
                continue
            try:
                seg_id = int(name[:-4])
            except ValueError:
                continue
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                blob = f.read()
            aligned, seq, _count = verify_frames(blob)
            if aligned < len(blob):
                with open(path, "r+b") as f:
                    f.truncate(aligned)
                    f.flush()
                    os.fsync(f.fileno())
            prog[seg_id] = aligned
            max_seq = max(max_seq, seq)
        return prog, max_seq

    async def poll_once(self) -> int:
        """One full shipping pass: list, tail-read every segment with
        new committed bytes, mirror + fsync, drop segments the primary
        truncated, then ack the durable watermark.  Returns total bytes
        shipped this pass."""
        snap = await self.source.snapshot()
        self._hw = {log: int(hw)
                    for log, hw in snap.get("high_watermarks", {}).items()}
        self._flushed = {log: int(seq) for log, seq
                         in snap.get("flushed_seqs", {}).items()}
        total = 0
        for log, segs in snap.get("logs", {}).items():
            if log not in self._progress:
                prog0, seq0 = await asyncio.to_thread(
                    self._recover_log_blocking, log)
                self._progress[log] = prog0
                if seq0:
                    self.shipped_seqs[log] = max(
                        self.shipped_seqs.get(log, 0), seq0)
            prog = self._progress.setdefault(log, {})
            seen: set[int] = set()
            for seg in segs:
                seg_id = int(seg["id"])
                seen.add(seg_id)
                total += await self._ship_segment(log, seg_id,
                                                 int(seg["size"]))
            # segments gone from the listing were truncated (all seqs
            # flushed to shared SSTs + acked): the mirror drops them
            # too, bounding follower disk to the primary's WAL backlog.
            # Only honored when the remote's flushed floor COVERS what
            # we shipped for this log — a listing that drops segments
            # without the SST floor to justify it is a dying/aborted
            # primary, and these mirror bytes are the failover
            # candidate's only copy of the acked tail.
            if self._flushed.get(log, 0) >= self.shipped_seqs.get(log, 0):
                for seg_id in sorted(set(prog) - seen):
                    await asyncio.to_thread(
                        self._unlink_blocking,
                        self._mirror_path(log, seg_id))
                    prog.pop(seg_id, None)
            self._refresh_lag()
        if self.shipped_seqs:
            await self.source.ack(dict(self.shipped_seqs))
        return total

    async def _ship_segment(self, log: str, seg_id: int,
                            remote_size: int) -> int:
        prog = self._progress.setdefault(log, {})
        mirrored = self._mirrored_size(log, seg_id)
        prog.setdefault(seg_id, mirrored)
        shipped = 0
        while mirrored < remote_size and not self._stopping:
            res = await self.source.read(
                log, seg_id, mirrored,
                max(1, self.config.max_batch_bytes))
            if res is None:
                break  # truncated mid-poll; the next listing drops it
            blob, _sealed = res
            if not blob:
                break
            aligned, max_seq, _count = verify_frames(blob)
            if aligned == 0:
                # a nonzero read that verifies to nothing means the
                # offset no longer sits on a frame boundary (mirror
                # corrupted out-of-band?) — resync this segment from
                # scratch rather than shipping garbage
                logger.warning(
                    "wal mirror %s/%d: unverifiable chunk at offset "
                    "%d; resyncing segment", log, seg_id, mirrored)
                await asyncio.to_thread(
                    self._unlink_blocking, self._mirror_path(log, seg_id))
                prog[seg_id] = 0
                mirrored = 0
                continue
            await asyncio.to_thread(
                self._append_blocking, self._mirror_path(log, seg_id),
                blob[:aligned])
            mirrored += aligned
            prog[seg_id] = mirrored
            shipped += aligned
            _SHIPPED_BYTES.inc(aligned)
            if max_seq:
                self.shipped_seqs[log] = max(
                    self.shipped_seqs.get(log, 0), max_seq)
            if aligned < len(blob):
                # trailing partial frame: the rest arrives once the
                # primary commits it; do not spin on it this pass
                break
        return shipped

    def _append_blocking(self, path: str, blob: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())

    def _unlink_blocking(self, path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    def _refresh_lag(self) -> None:
        self._lag_child.set(self.lag())

    def lag(self) -> int:
        """Primary high-watermark minus durably covered seq, maxed over
        logs (0 = fully caught up).  A seq is covered when mirrored OR
        committed to a shared SST by the primary (its segment may be
        truncated — there is nothing left to ship)."""
        return max((hw - max(self.shipped_seqs.get(log, 0),
                             self._flushed.get(log, 0))
                    for log, hw in self._hw.items()), default=0)

    def healthy(self, max_lag_seqs: int = 0) -> bool:
        return self.lag() <= max_lag_seqs


# ---- failover ---------------------------------------------------------------


async def promote(root_path: str, store: ObjectStore, region_id: int,
                  lease_manager: LeaseManager, holder: str,
                  mirror_dir: str, wal_config, *,
                  segment_ms: int = 2 * 3600 * 1000, config=None,
                  lease_ttl_ms: int = 10_000,
                  reason: str = "primary_dead", url: str = "",
                  pre_open: Optional[
                      Callable[[], Awaitable[None]]] = None,
                  device="cuda"):
    """Failover: acquire the region's lease (bumping the epoch — the
    old primary is fenced from here on), then open a full engine over
    the region's SHARED paths with the WAL dir pointed at the mirror.
    Replay rebuilds the acked-but-unflushed tail into memtables with
    seqs preserved; flushed data comes from the shared SSTs via the
    manifest — together, grids byte-identical with what the old
    primary would have served.

    `url` is stamped into the lease record so lease-backed routing can
    re-resolve the region's owner after the takeover.  `pre_open` runs
    AFTER the lease is won but BEFORE the engine opens — the standby
    monitor uses it to stop its follower's ship loop, so no mirror
    append can race the replay (losers never reach it: a lost acquire
    raises first, leaving the follower tailing untouched).

    The engine opens on `device` ("cuda" by default; raises without a
    card).  Returns (engine, lease); the lease is already installed as
    the fence on every WAL-fronted table and renewal is NOT started (the
    caller owns the heartbeat policy).
    """
    import dataclasses

    from horaedb_tpu_torch.metric_engine import MetricEngine

    lease = await lease_manager.acquire(region_id, holder,
                                        ttl_ms=lease_ttl_ms, url=url)
    lease.grant_ttl_ms(lease_ttl_ms)
    wal_cfg = dataclasses.replace(wal_config, enabled=True,
                                  dir=mirror_dir)
    try:
        if pre_open is not None:
            await pre_open()
        engine = await MetricEngine.open(
            f"{root_path}/region_{region_id}", store,
            segment_ms=segment_ms, config=config, wal_config=wal_cfg,
            device=device)
    except BaseException:
        await lease.release()
        raise
    install_fence(engine, lease)
    _FAILOVERS.labels(reason=reason).inc()
    logger.info("failover: promoted %r for region %d at epoch %d (%s)",
                holder, region_id, lease.epoch, reason)
    return engine, lease


class StandbyMonitor:
    """Self-driving failover: one per standby (a `WalFollower` with
    [failover] on).  The loop — registered and heartbeated like every
    background loop — polls the primary's lease record in the SHARED
    store and treats it as the sole source of truth:

      * record live            -> reset; retarget tailing at its holder
      * record expired/missing -> arm a jittered grace deadline; once
        past it, run an ELECTION

    An election is the lease's monotonic-epoch acquire, nothing more:
    every standby that reaches its deadline publishes a FITNESS record
    (highest durably mirrored seq) next to the lease, waits one beat,
    and stands down if a fresh sibling record is strictly fitter — so
    the freshest mirror normally acquires uncontested, and when two
    tie the acquire's read-back verify still picks exactly one winner.
    Losers fall back to tailing the new primary (via `retarget`) under
    a cooldown, which is the flapping suppression: a standby that just
    lost cannot immediately re-arm against the winner's first renewal
    hiccup.

    A store PARTITION never elects: the deadline only arms/fires off a
    SUCCESSFUL read showing the lease expired, and an unreachable
    store fails the acquire anyway — the conservative outcome is a
    region with no primary, never two.
    """

    def __init__(self, follower: WalFollower,
                 lease_manager: LeaseManager, region_id: int,
                 holder: str, config: Optional[FailoverConfig],
                 wal_config, *,
                 segment_ms: int = 2 * 3600 * 1000, engine_config=None,
                 lease_ttl_ms: int = 10_000, url: str = "",
                 on_promoted: Optional[Callable] = None,
                 retarget: Optional[Callable] = None,
                 clock: Callable[[], int] = now_ms, rng=None,
                 device="cuda"):
        import random

        self.follower = follower
        self.lease_manager = lease_manager
        self.region = region_id
        self.holder = holder
        self.config = config or FailoverConfig()
        self.wal_config = wal_config
        self.segment_ms = segment_ms
        self.engine_config = engine_config
        self.lease_ttl_ms = lease_ttl_ms
        self.url = url
        # the torch device the promoted engine opens on
        self.device = device
        # async (engine, lease) -> None: the owner's takeover hook
        # (start renewal, swap the served engine, open a hub...)
        self.on_promoted = on_promoted
        # async LeaseRecord -> None: re-point self.follower at the
        # record's holder (None = keep tailing the original source)
        self._retarget = retarget
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self.role = "standby"
        self.engine = None
        self.lease: Optional[Lease] = None
        self.attempts = 0
        self.last_outcome: Optional[dict] = None
        self._observed: Optional[LeaseRecord] = None
        self._grace_deadline_ms: Optional[int] = None
        self._cooldown_until_ms = 0
        self._retargeted_epoch = 0
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    # ---- observability ----------------------------------------------------

    def election_state(self) -> dict:
        """/repl/status + /debug/tasks backlog: everything an operator
        needs to see where this standby stands in an election."""
        obs = self._observed
        return {
            "role": self.role,
            "region": self.region,
            "holder": self.holder,
            "observed_epoch": obs.epoch if obs is not None else 0,
            "observed_holder": obs.holder if obs is not None else "",
            "grace_deadline_ms": self._grace_deadline_ms,
            "cooldown_until_ms": self._cooldown_until_ms,
            "attempts": self.attempts,
            "last_outcome": self.last_outcome,
        }

    def _outcome(self, outcome: str, detail: str = "") -> None:
        rec = {"outcome": outcome, "at_ms": self._clock()}
        if detail:
            rec["detail"] = detail
        self.last_outcome = rec
        _ELECTIONS.labels(outcome=outcome).inc()

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        ensure(self._task is None, "standby monitor already started")
        interval = self.config.check_interval.seconds
        self._task = loops.spawn(
            lambda hb: self._loop(hb, interval),
            name=f"standby-monitor:region_{self.region}",
            kind="standby-monitor", owner="replication",
            period_s=interval, backlog=self.election_state)

    async def close(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # best-effort: drop our fitness record so a later election
        # round never weighs a departed standby
        try:
            await self.lease_manager.store.delete(self._fitness_path())
        except Exception:  # noqa: BLE001 — NotFound / store gone
            pass

    async def _loop(self, hb, interval_s: float) -> None:
        while not self._stopping:
            hb.beat()
            try:
                await self._tick()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — store partition
                # or election error: nothing arms or fires without a
                # successful lease read, so just retry next tick
                hb.error(exc)
                logger.warning("standby monitor region %d: %s",
                               self.region, exc)
            if self._stopping:
                return
            await asyncio.sleep(interval_s)

    # ---- the watch/elect state machine ------------------------------------

    async def _tick(self) -> None:
        if self.role != "standby":
            return
        now = self._clock()
        rec = await self.lease_manager.read(self.region)
        if (rec is not None and rec.holder
                and rec.expires_at_ms > now):
            # live primary: disarm, and (once per epoch) re-point our
            # tailing at whoever holds the lease now — the loser path
            self._observed = rec
            self._grace_deadline_ms = None
            if (rec.holder != self.holder
                    and self._retarget is not None
                    and rec.epoch > self._retargeted_epoch):
                await self._retarget(rec)
                self._retargeted_epoch = rec.epoch
            return
        if now < self._cooldown_until_ms:
            return
        if self._grace_deadline_ms is None:
            grace_ms = int(self.config.grace.seconds * 1000)
            jitter_ms = int(self._rng.random() * self.config.jitter
                            * grace_ms)
            self._grace_deadline_ms = now + grace_ms + jitter_ms
            await self._publish_fitness()
            return
        # keep our fitness fresh while the grace window runs, so
        # siblings deciding at their own deadlines see current numbers
        await self._publish_fitness()
        if now < self._grace_deadline_ms:
            return
        await self._elect()

    async def _elect(self) -> None:
        # final drain: the primary is presumed dead, but its already-
        # committed tail may still be readable (shared hub / surviving
        # log plane) — best effort, a dead wire just fails fast
        try:
            await self.follower.poll_once()
        except Exception:  # noqa: BLE001 — dead primary, expected
            pass
        await self._publish_fitness()
        await asyncio.sleep(self.config.fitness_wait.seconds)
        fitter = await self._fresher_sibling()
        if fitter is not None:
            # stand down this round; re-arm so we run again if the
            # fitter sibling dies before claiming
            self._outcome("deferred", detail=f"fresher mirror {fitter}")
            self._grace_deadline_ms = None
            self._cooldown_until_ms = (
                self._clock()
                + int(self.config.cooldown.seconds * 1000))
            return
        self.attempts += 1
        try:
            engine, lease = await promote(
                self.lease_manager.root_path, self.lease_manager.store,
                self.region, self.lease_manager, self.holder,
                self.follower.mirror_dir, self.wal_config,
                segment_ms=self.segment_ms, config=self.engine_config,
                lease_ttl_ms=self.lease_ttl_ms,
                reason="standby_election", url=self.url,
                pre_open=self.follower.close, device=self.device)
        except ReplicationError as exc:
            # lost the race (a sibling's acquire landed first): fall
            # back to tailing — the next live-lease tick retargets us
            self._outcome("lost", detail=str(exc))
            self._grace_deadline_ms = None
            self._cooldown_until_ms = (
                self._clock()
                + int(self.config.cooldown.seconds * 1000))
            return
        self.engine, self.lease = engine, lease
        self.role = "primary"
        self._grace_deadline_ms = None
        self._outcome("won", detail=f"epoch {lease.epoch}")
        self._stopping = True
        logger.info("standby %r won region %d election at epoch %d",
                    self.holder, self.region, lease.epoch)
        if self.on_promoted is not None:
            await self.on_promoted(engine, lease)

    # ---- fitness: freshest mirror wins ------------------------------------

    def _fitness_path(self, holder: Optional[str] = None) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in (holder or self.holder))
        return (f"{self.lease_manager.root_path}/leases/"
                f"region_{self.region}.fitness.{safe}.json")

    def _fitness(self) -> int:
        """Durably covered progress, summed over logs (seqs are
        per-log monotonic, so the sum is monotone in coverage).  Falls
        back to scanning the mirror's own frames when the follower has
        not polled yet (a standby restarted straight into an outage)."""
        f = self.follower
        logs = set(f.shipped_seqs) | set(f._flushed)
        if not logs:
            return sum(mirror_watermarks(f.mirror_dir).values())
        return sum(max(f.shipped_seqs.get(log, 0),
                       f._flushed.get(log, 0)) for log in logs)

    async def _publish_fitness(self) -> None:
        rec = {"holder": self.holder, "fitness": self._fitness(),
               "at_ms": self._clock()}
        await self.lease_manager.store.put(
            self._fitness_path(), json.dumps(rec).encode())

    async def _fresher_sibling(self) -> Optional[str]:
        """The holder of a FRESH sibling fitness record strictly fitter
        than ours, else None.  Stale records (older than the grace
        horizon) are a departed standby's leftovers and never block."""
        store = self.lease_manager.store
        prefix = (f"{self.lease_manager.root_path}/leases/"
                  f"region_{self.region}.fitness.")
        now = self._clock()
        horizon_ms = max(
            1000,
            int(self.config.grace.seconds * 1000)
            + 2 * int(self.config.fitness_wait.seconds * 1000))
        mine = self._fitness()
        my_path = self._fitness_path()
        for meta in await store.list(prefix):
            if meta.path == my_path:
                continue
            try:
                d = json.loads(await store.get(meta.path))
            except (NotFoundError, ValueError):
                continue
            if now - int(d.get("at_ms", 0)) > horizon_ms:
                continue
            if int(d.get("fitness", 0)) > mine:
                return str(d.get("holder", meta.path))
        return None


# ---- auto-executed rebalance ------------------------------------------------


class RebalanceExecutor:
    """Executes the health monitor's split recommendations under the
    [rebalance] safety envelope.  Every plan entry flows through the
    same gate order — disabled / cooldown / throttle / replica-health
    / dry-run — and every decision is counted
    (`rebalance_moves_total{kind,outcome}`) and kept in a bounded
    history for /debug/tasks.

    Split entries carry machine-executable fields (pivot_key,
    new_region_id) from `Cluster._rebalance_from_stats`; whole-region
    moves need a peer to adopt the region, which this node cannot
    conjure — they record `no_target` unless a `move_target` hook is
    wired by an outer control plane."""

    _HISTORY = 32

    def __init__(self, cluster, config: Optional[RebalanceConfig] = None,
                 clock: Callable[[], int] = now_ms):
        self.cluster = cluster
        self.config = config or RebalanceConfig()
        self._clock = clock
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._last_move_ms: dict[int, int] = {}
        self._inflight = 0
        self.history: list[dict] = []
        # Optional[Callable[[int], bool]]: is region `rid`'s replica
        # healthy enough to survive losing its primary mid-move?  None
        # = no replica wired = vacuously healthy
        self.replica_healthy: Optional[Callable[[int], bool]] = None
        # Optional[Callable[[int, dict], Awaitable[bool]]]: execute a
        # whole-region move (detach here + adopt elsewhere); absent by
        # default
        self.move_target: Optional[
            Callable[[int, dict], Awaitable[bool]]] = None

    def start(self) -> None:
        ensure(self._task is None, "rebalance executor already started")
        interval = self.config.interval.seconds
        self._task = loops.spawn(
            lambda hb: self._loop(hb, interval),
            name="rebalance-exec", kind="rebalance", owner="cluster",
            period_s=interval,
            backlog=lambda: {"inflight": self._inflight,
                             "dry_run": self.config.dry_run,
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
                await self.run_once()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — next tick retries
                hb.error(exc)
                logger.exception("rebalance pass failed")

    async def run_once(self) -> list[dict]:
        """One executor pass over the freshest survey plan.  Returns
        the outcome records (also appended to `history`)."""
        survey = self.cluster.rebalance_survey
        if survey is None:
            survey = await self.cluster.survey_load(self.config.skew_ratio)
        outcomes = []
        for entry in survey.get("plan", []):
            outcomes.append(await self._execute(entry))
        return outcomes

    def _record(self, entry: dict, kind: str, outcome: str,
                detail: str = "") -> dict:
        rec = {"region": entry.get("region"), "kind": kind,
               "outcome": outcome, "at_ms": self._clock()}
        if detail:
            rec["detail"] = detail
        _REBALANCE_MOVES.labels(kind=kind, outcome=outcome).inc()
        self.history.append(rec)
        del self.history[:-self._HISTORY]
        return rec

    async def _execute(self, entry: dict) -> dict:
        cfg = self.config
        rid = int(entry["region"])
        kind = entry.get("kind") or (
            "split" if entry.get("new_region_id") is not None else "move")
        if not cfg.enabled:
            return self._record(entry, kind, "disabled")
        last = self._last_move_ms.get(rid)
        if (last is not None
                and self._clock() - last < cfg.cooldown.seconds * 1000):
            return self._record(entry, kind, "cooldown")
        if self._inflight >= cfg.max_concurrent_moves:
            return self._record(entry, kind, "throttled")
        if (cfg.require_replica_healthy
                and self.replica_healthy is not None
                and not self.replica_healthy(rid)):
            return self._record(entry, kind, "replica_unhealthy")
        if cfg.dry_run:
            return self._record(entry, kind, "dry_run",
                                detail=entry.get("reason", ""))
        if kind == "split":
            pivot = entry.get("pivot_key")
            new_rid = entry.get("new_region_id")
            if pivot is None or new_rid is None:
                return self._record(entry, kind, "no_pivot")
            self._inflight += 1
            try:
                await self.cluster.split_region(
                    rid, int(pivot), int(new_rid), cfg.table_ttl_ms)
            except Exception as exc:  # noqa: BLE001 — counted, surfaced
                return self._record(entry, kind, "error", detail=str(exc))
            finally:
                self._inflight -= 1
            self._last_move_ms[rid] = self._clock()
            return self._record(entry, kind, "executed")
        # whole-region move: needs a peer to adopt it
        if self.move_target is None:
            return self._record(entry, kind, "no_target")
        self._inflight += 1
        try:
            moved = await self.move_target(rid, entry)
        except Exception as exc:  # noqa: BLE001 — counted, surfaced
            return self._record(entry, kind, "error", detail=str(exc))
        finally:
            self._inflight -= 1
        if not moved:
            return self._record(entry, kind, "declined")
        self._last_move_ms[rid] = self._clock()
        return self._record(entry, kind, "executed")
