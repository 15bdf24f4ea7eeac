"""Per-tenant isolation primitives (docs/robustness.md, tenant
isolation failure domains).

A tenant identity enters at HTTP ingress (`X-Tenant` header; absent ->
the shared "default" tenant) and rides the same ambient-contextvar
plumbing the request `Deadline` uses: layers that never knew about
tenants need no signature changes, and worker-pool jobs dispatched via
`runtimes.run` / `asyncio.to_thread` see the tenant too (contextvars
are copied onto the executor).

Resource governance lives at the layer that owns the resource (the
Taurus NDP framing, PAPERS.md):

  * admission owns CONCURRENCY — weighted-fair queueing over per-tenant
    queues in the server (`server/main.py`, FairAdmissionController),
    driven by this module's `TenantLimits.weight / max_in_flight /
    max_queued`;
  * the scan path owns BYTES — `charge_scan_bytes()` charges the
    ambient tenant's scan token bucket at the read-stage attribution
    points (`storage/read.py`), and the deadline machinery's
    cooperative `checkpoint()` calls (storage/read.py,
    storage/pipeline.py) observe a bucket in deficit via the
    checkpoint hook registered here -> `QuotaExceeded` -> HTTP 429
    with a quota error body, never a silent slow-down;
  * the WAL owns INGEST RATE — `Tenant.admit_wal()` is consulted in
    `wal/ingest.py` ahead of the group-commit append, so a flooding
    writer is rejected before it costs an fsync.

Buckets are classic token buckets (rate + burst, monotonic clock,
thread-safe — charges arrive from pool threads).  A breach always
carries a `retry_after_s` derived from the actual deficit, so backoff
guidance tracks how far over budget the tenant is.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from horaedb_tpu_torch.common import deadline as deadline_mod
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.size_ext import ReadableSize
from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.utils.metrics import registry

DEFAULT_TENANT = "default"

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# per-tenant resource accounting; children are keyed tenant= (and
# resource= for the rejection counter) and removed when a tenant's
# config is dropped at reload (TenantRegistry.reload) so /metrics
# never serves phantom tenants
_SCAN_BYTES = registry.counter(
    "tenant_scan_bytes_total",
    "bytes entering the scan read stages, charged to the requesting "
    "tenant's scan budget")
_WAL_BYTES = registry.counter(
    "tenant_wal_bytes_total",
    "bytes admitted into the WAL group commit per tenant")
_QUOTA_REJECTIONS = registry.counter(
    "tenant_quota_rejections_total",
    "requests rejected with 429 for a per-tenant resource quota "
    "breach (resource=scan_bytes|wal_rate)")
_QUERY_SECONDS = registry.histogram(
    "tenant_query_seconds",
    "governed-endpoint request latency per tenant (server-side)")


class QuotaExceeded(Error):
    """A per-tenant resource quota was breached.  The server maps this
    to HTTP 429 with a quota error body and a Retry-After derived from
    the bucket's actual deficit (never a constant)."""

    def __init__(self, tenant: str, resource: str, retry_after_s: float,
                 detail: str = ""):
        self.tenant = tenant
        self.resource = resource
        self.retry_after_s = max(0.0, retry_after_s)
        msg = (f"tenant {tenant!r} over its {resource} quota"
               + (f": {detail}" if detail else ""))
        super().__init__(msg)


class TokenBucket:
    """rate/burst token bucket on the monotonic clock.  Thread-safe:
    scan-byte charges arrive from worker-pool threads while the event
    loop checks the level at checkpoints."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock=time.monotonic):
        ensure(rate_per_s > 0, "token bucket rate must be positive")
        self.rate = float(rate_per_s)
        self.burst = max(float(burst), 1.0)
        self._clock = clock
        self._level = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        dt = now - self._last
        if dt > 0:
            self._level = min(self.burst, self._level + dt * self.rate)
            self._last = now

    @property
    def level(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._level

    def admit(self, cost: float) -> bool:
        """Take `cost` tokens if affordable (pre-pay semantics: the WAL
        path).  A cost larger than the whole burst is admitted only
        against a FULL bucket (leaving it in deficit) — otherwise a
        big batch could never be admitted at all."""
        with self._lock:
            self._refill_locked()
            need = min(cost, self.burst)
            if self._level < need:
                return False
            self._level -= cost
            return True

    def charge(self, cost: float) -> None:
        """Deduct unconditionally, possibly into deficit (post-pay
        semantics: scan bytes are charged after the read happened; the
        deficit is observed at the next cooperative checkpoint)."""
        with self._lock:
            self._refill_locked()
            self._level -= cost

    @property
    def in_deficit(self) -> bool:
        return self.level < 0.0

    def delay_until(self, target: float = 0.0) -> float:
        """Seconds until the level refills to `target` (0 = out of
        deficit) — the Retry-After hint for a breach."""
        lvl = self.level
        if lvl >= target:
            return 0.0
        return (target - lvl) / self.rate


@dataclass
class TenantLimits:
    """One tenant's isolation envelope ([tenants.default] /
    [tenants.tenant.<name>]; unset per-tenant fields inherit from the
    default).  Zero means "unlimited / global bound only" for every
    field except weight and max_queued."""

    # weighted-fair admission share (stride scheduling): every grant
    # advances the tenant's virtual pass by 1/weight and a freed slot
    # goes to the eligible tenant with the lowest pass, so contending
    # tenants receive slots in proportion to their weights over time
    weight: float = 1.0
    # hard cap on this tenant's concurrently EXECUTING queries
    # (0 = bounded only by [admission] max_concurrent_queries)
    max_in_flight: int = 0
    # this tenant's own admission wait queue; arrivals beyond it are
    # shed with a 429 scoped to the tenant
    max_queued: int = 64
    # operator-side deadline CAP for this tenant's requests (0 =
    # inherit the [admission] per-endpoint defaults): a no-SLO batch
    # class capped at, say, 1s cannot hold server time — CPU, pool
    # slots, the GIL — for long stretches even when its queries are
    # admitted, which bounds the collateral its work inflicts on
    # latency-SLO tenants sharing the host
    max_query_time: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(0))
    # scan-byte budget: a token bucket charged at the read-stage
    # attribution points (0 = unlimited)
    scan_bytes_per_s: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))
    scan_burst_bytes: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))  # 0 -> 2s of rate
    # WAL ingest-rate budget, consulted ahead of group commit
    # (0 = unlimited)
    wal_bytes_per_s: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))
    wal_burst_bytes: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))  # 0 -> 2s of rate


@dataclass
class TenantsConfig:
    """[tenants]: per-tenant isolation (weighted-fair admission +
    resource quotas).  Disabled reproduces the pre-tenant global
    admission behavior exactly — the server keeps the single FIFO
    controller and no quota machinery binds."""

    enabled: bool = False
    # auto_tenants = true mints unknown X-Tenant names their OWN
    # runtime tenant with the default limits (bounded by
    # max_auto_tenants).  X-Tenant is UNAUTHENTICATED, so each fresh
    # name is a fresh fair share and a fresh set of quota buckets — a
    # client rotating names multiplies its share until the cap.  The
    # default is therefore OFF: unknown names share the single
    # "default" tenant (one weight, one bucket set — rotation gains
    # nothing).  Turn it on only where the ingress layer has already
    # authenticated the tenant header.
    auto_tenants: bool = False
    max_auto_tenants: int = 64
    default: TenantLimits = field(default_factory=TenantLimits)
    tenants: dict = field(default_factory=dict)  # name -> TenantLimits


_LIMIT_KEYS = ("weight", "max_in_flight", "max_queued",
               "max_query_time",
               "scan_bytes_per_s", "scan_burst_bytes",
               "wal_bytes_per_s", "wal_burst_bytes")
_SIZE_KEYS = {"scan_bytes_per_s", "scan_burst_bytes",
              "wal_bytes_per_s", "wal_burst_bytes"}


def _limits_from_dict(data: dict, base: TenantLimits,
                      where: str) -> TenantLimits:
    ensure(isinstance(data, dict), f"{where} expects a config table")
    unknown = set(data) - set(_LIMIT_KEYS)
    ensure(not unknown,
           f"unknown keys for {where}: {sorted(unknown)}")
    kwargs = {k: getattr(base, k) for k in _LIMIT_KEYS}
    for key, value in data.items():
        if key == "max_query_time":
            if not isinstance(value, ReadableDuration):
                ensure(isinstance(value, str),
                       f'{where}.max_query_time expects a duration '
                       'string like "1s"')
                value = ReadableDuration.parse(value)
            kwargs[key] = value
        elif key in _SIZE_KEYS:
            if not isinstance(value, ReadableSize):
                ensure(isinstance(value, (str, int)),
                       f'{where}.{key} expects a size like "64MiB"')
                value = (ReadableSize(value) if isinstance(value, int)
                         else ReadableSize.parse(value))
            kwargs[key] = value
        elif key == "weight":
            ensure(isinstance(value, (int, float))
                   and not isinstance(value, bool) and value > 0,
                   f"{where}.weight must be a positive number")
            kwargs[key] = float(value)
        else:
            ensure(isinstance(value, int) and not isinstance(value, bool)
                   and value >= 0,
                   f"{where}.{key} must be a non-negative integer")
            kwargs[key] = value
    return TenantLimits(**kwargs)


def tenants_from_dict(data: dict) -> TenantsConfig:
    """[tenants] TOML table -> TenantsConfig.  Per-tenant tables live
    under [tenants.tenant.<name>] and inherit unset fields from
    [tenants.default]."""
    ensure(isinstance(data, dict), "[tenants] expects a config table")
    known = {"enabled", "auto_tenants", "max_auto_tenants", "default",
             "tenant"}
    unknown = set(data) - known
    ensure(not unknown, f"unknown [tenants] keys: {sorted(unknown)}")
    cfg = TenantsConfig()
    if "enabled" in data:
        ensure(isinstance(data["enabled"], bool),
               "[tenants] enabled must be a boolean")
        cfg.enabled = data["enabled"]
    if "auto_tenants" in data:
        ensure(isinstance(data["auto_tenants"], bool),
               "[tenants] auto_tenants must be a boolean")
        cfg.auto_tenants = data["auto_tenants"]
    if "max_auto_tenants" in data:
        v = data["max_auto_tenants"]
        ensure(isinstance(v, int) and not isinstance(v, bool) and v >= 0,
               "[tenants] max_auto_tenants must be a non-negative int")
        cfg.max_auto_tenants = v
    if "default" in data:
        cfg.default = _limits_from_dict(data["default"], TenantLimits(),
                                        "[tenants.default]")
    for name, table in (data.get("tenant") or {}).items():
        ensure(_NAME_RE.match(name) is not None,
               f"bad tenant name {name!r} (want [A-Za-z0-9._-]{{1,64}})")
        ensure(name != DEFAULT_TENANT,
               "configure the default tenant via [tenants.default], "
               "not [tenants.tenant.default]")
        cfg.tenants[name] = _limits_from_dict(
            table, cfg.default, f"[tenants.tenant.{name}]")
    return cfg


class Tenant:
    """Runtime tenant state: quota buckets + pre-bound metric children.
    One instance per distinct tenant name; admission-queue state lives
    in the server's FairAdmissionController."""

    def __init__(self, name: str, limits: TenantLimits,
                 auto: bool = False, clock=time.monotonic):
        self.name = name
        self.limits = limits
        self.auto = auto
        scan_rate = limits.scan_bytes_per_s.bytes
        self.scan_bucket = (TokenBucket(
            scan_rate, limits.scan_burst_bytes.bytes or 2 * scan_rate,
            clock=clock) if scan_rate else None)
        wal_rate = limits.wal_bytes_per_s.bytes
        self.wal_bucket = (TokenBucket(
            wal_rate, limits.wal_burst_bytes.bytes or 2 * wal_rate,
            clock=clock) if wal_rate else None)
        self._scan_bytes = _SCAN_BYTES.labels(tenant=name)
        self._wal_bytes = _WAL_BYTES.labels(tenant=name)
        self.query_seconds = _QUERY_SECONDS.labels(tenant=name)

    def charge_scan_bytes(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self._scan_bytes.inc(nbytes)
        if self.scan_bucket is not None:
            self.scan_bucket.charge(nbytes)

    def check_scan_budget(self) -> None:
        """Raise QuotaExceeded when the scan bucket is in deficit —
        called from the deadline machinery's cooperative checkpoints,
        so a breach surfaces within one checkpoint interval."""
        b = self.scan_bucket
        if b is not None and b.in_deficit:
            raise QuotaExceeded(self.name, "scan_bytes",
                                b.delay_until(0.0),
                                "scan-byte budget exhausted")

    def admit_wal(self, nbytes: int) -> None:
        """Admit `nbytes` of WAL ingest or raise QuotaExceeded — the
        check runs AHEAD of the group-commit append, so a rejected
        write never costs an fsync."""
        b = self.wal_bucket
        if b is not None and not b.admit(nbytes):
            raise QuotaExceeded(
                self.name, "wal_rate",
                b.delay_until(min(nbytes, b.burst)),
                f"ingest of {nbytes} bytes exceeds the WAL rate budget")
        self._wal_bytes.inc(nbytes)

    def quota_rejected(self, resource: str) -> None:
        """Server-side accounting hook: exactly one inc per 429
        response (the raise sites don't count — a breach can be
        observed at several checkpoints before the query dies)."""
        _QUOTA_REJECTIONS.labels(tenant=self.name,
                                 resource=resource).inc()

    def remove_metrics(self) -> None:
        """Drop this tenant's children from every tenant-labeled
        family so a removed tenant stops rendering on /metrics (same
        discipline as the heartbeat-age zeroing: gone means gone)."""
        for fam in (_SCAN_BYTES, _WAL_BYTES, _QUERY_SECONDS):
            fam.remove(tenant=self.name)
        for resource in ("scan_bytes", "wal_rate"):
            _QUOTA_REJECTIONS.remove(tenant=self.name, resource=resource)
        # the server's admission families label by tenant too
        for name in ("server_queries_shed_total",
                     "server_queries_queue_timeout_total",
                     "server_requests_timed_out_total",
                     "server_active_queries", "server_queued_queries"):
            fam = registry.family(name)
            if fam is not None:
                fam.remove(tenant=self.name)

    def stats(self) -> dict:
        out = {
            "weight": self.limits.weight,
            "max_in_flight": self.limits.max_in_flight,
            "max_queued": self.limits.max_queued,
            "auto": self.auto,
            "scan_bytes": self._scan_bytes.value,
            "wal_bytes": self._wal_bytes.value,
            "query_p50_s": self.query_seconds.quantile(0.5),
            "query_p99_s": self.query_seconds.quantile(0.99),
            "queries": self.query_seconds.count,
        }
        if self.scan_bucket is not None:
            out["scan_bucket_level"] = round(self.scan_bucket.level)
        if self.wal_bucket is not None:
            out["wal_bucket_level"] = round(self.wal_bucket.level)
        return out


class TenantRegistry:
    """name -> Tenant for one server, built from [tenants].  Unknown
    names become bounded auto-tenants with the default limits; at
    reload, tenants dropped from the config have their metric children
    removed so /metrics never serves phantom tenants."""

    def __init__(self, config: TenantsConfig, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.configure(config)

    def configure(self, config: TenantsConfig) -> list:
        """(Re)build from `config`; returns the removed tenant names.
        Bucket levels reset — a reload is a policy change, not an
        accounting continuation."""
        with self._lock:
            old = getattr(self, "_tenants", {})
            self.config = config
            self._tenants = {
                DEFAULT_TENANT: Tenant(DEFAULT_TENANT, config.default,
                                       clock=self._clock)}
            for name, limits in config.tenants.items():
                self._tenants[name] = Tenant(name, limits,
                                             clock=self._clock)
            removed = [n for n in old if n not in self._tenants]
            for name in removed:
                old[name].remove_metrics()
            return removed

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def resolve(self, name: Optional[str]) -> Tenant:
        """The Tenant for an X-Tenant header value (None/"" -> the
        default tenant).  Raises Error on a malformed name — the
        server answers 400 before anything is charged."""
        if not name:
            name = DEFAULT_TENANT
        if _NAME_RE.match(name) is None:
            raise Error(f"bad X-Tenant {name!r} "
                        "(want [A-Za-z0-9._-]{1,64})")
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                return t
            if (not self.config.auto_tenants
                    or len(self._tenants) - 1 - len(self.config.tenants)
                    >= self.config.max_auto_tenants):
                return self._tenants[DEFAULT_TENANT]
            t = Tenant(name, self.config.default, auto=True,
                       clock=self._clock)
            self._tenants[name] = t
            return t

    def known(self) -> list:
        with self._lock:
            return list(self._tenants.values())

    def stats(self) -> dict:
        return {t.name: t.stats() for t in self.known()}


_CURRENT: contextvars.ContextVar[Optional[Tenant]] = \
    contextvars.ContextVar("horaedb_tenant", default=None)


def current_tenant() -> Optional[Tenant]:
    """The ambient tenant, or None outside any governed request scope
    (background loops: flusher, compaction, meta-ingest — ungoverned
    by design; their resource use is the system's own)."""
    return _CURRENT.get()


class tenant_scope:
    """Bind a tenant as ambient for the `with` body (sync or async)."""

    __slots__ = ("tenant", "_token")

    def __init__(self, tenant: Optional[Tenant]):
        self.tenant = tenant
        self._token = None

    def __enter__(self) -> Optional[Tenant]:
        self._token = _CURRENT.set(self.tenant)
        return self.tenant

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


def charge_scan_bytes(nbytes: int) -> None:
    """Charge the ambient tenant's scan budget (no-op outside a tenant
    scope).  Called at the read-stage byte-attribution points — pool
    threads included, since runtimes.run copies contextvars."""
    t = _CURRENT.get()
    if t is not None:
        t.charge_scan_bytes(nbytes)


def _budget_checkpoint() -> None:
    """Deadline-checkpoint hook: a scan bucket in deficit surfaces at
    the same cooperative cancellation points an expired deadline does
    (storage/read.py, storage/pipeline.py)."""
    t = _CURRENT.get()
    if t is not None:
        t.check_scan_budget()


deadline_mod.add_checkpoint_hook(_budget_checkpoint)
