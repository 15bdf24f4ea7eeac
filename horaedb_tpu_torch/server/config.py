"""Server configuration (ref: src/server/src/config.rs:21-175).

Same layered-TOML shape: port, test write-load generator knobs, and the
metric-engine section holding the object-store choice plus the
storage config.  Every section and every validation error is the JAX
package's, so one TOML file loads alike in both.  `kind = "S3Like"`
selects objstore.s3.S3ObjectStore (endpoint, bucket and credentials
validated at load time).
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from dataclasses import dataclass, field
from typing import Any, Optional

from horaedb_tpu_torch.common import Error, ReadableDuration, ReadableSize, ensure
from horaedb_tpu_torch.common.tenant import TenantsConfig, tenants_from_dict
from horaedb_tpu_torch.cluster.breaker import BreakerConfig
from horaedb_tpu_torch.cluster.replication import (FailoverConfig,
                                             RebalanceConfig,
                                             ReplicationConfig)
from horaedb_tpu_torch.metric_engine.meta import MetaConfig
from horaedb_tpu_torch.rollup.config import RollupConfig, rollup_from_dict
from horaedb_tpu_torch.scanagent.config import ScanAgentConfig, scanagent_from_dict
from horaedb_tpu_torch.storage.config import StorageConfig, _check_scalar
from horaedb_tpu_torch.storage.config import from_dict as storage_from_dict
from horaedb_tpu_torch.wal.config import WalConfig


@dataclass
class AdmissionConfig:
    """[admission]: server-side query admission control + per-endpoint
    deadlines (docs/robustness.md, query-path failure domains).

    At most `max_concurrent_queries` queries execute at once; up to
    `max_queued` more wait at most `queue_timeout` for a slot.  Beyond
    that the server SHEDS: 429 when the wait queue is full, 503 when
    the queued wait times out, both with a Retry-After header — under
    overload, fast rejection beats slow collapse (TiLT/PAPERS.md:
    bounding per-request latency keeps a time-centric engine usable)."""

    enabled: bool = True
    max_concurrent_queries: int = 64
    max_queued: int = 128
    queue_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("500ms"))
    # per-endpoint default deadlines; a client may shrink (never grow
    # past max_timeout) via the X-Deadline-Ms header or timeout_ms param
    query_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("30s"))
    write_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("30s"))
    max_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("5m"))
    # floor for the Retry-After hint on 429/503 responses; the served
    # value is load-aware (derived from queue depth / observed service
    # rate, capped at max_retry_after) and falls back to this floor
    # when no service rate has been observed yet
    retry_after: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("1s"))
    max_retry_after: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("60s"))


@dataclass
class TraceConfig:
    """[trace]: request-scoped tracing (docs/observability.md).  Every
    query/write gets an X-Trace-Id; sampled traces record a span tree
    into a bounded in-memory ring served at /debug/traces, and traces
    over `slow_threshold` (or deadline-exceeded ones) hit the
    slow-query log + the slow_queries_total counter."""

    enabled: bool = True
    # completed traces kept in memory (FIFO eviction)
    ring_size: int = 256
    # at/over this duration a completed trace is logged as a slow query
    slow_threshold: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("1s"))
    # fraction of requests that record spans (the X-Trace-Id header is
    # minted regardless; an upstream-traced request is always recorded)
    sample_rate: float = 1.0
    # background-op traces (compaction, flush, WAL commit rounds,
    # rollup passes, scrub, health rounds) get their OWN ring so hot
    # ops never evict query traces, their own default slow threshold
    # (call sites override per-op), and their own sampling rate
    op_ring_size: int = 256
    op_slow_threshold: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("30s"))
    op_sample_rate: float = 1.0


@dataclass
class WatchdogConfig:
    """[watchdog]: the background-loop watchdog (common/loops.py).
    Every loop spawned through the loop registry heartbeats; a non-idle
    loop whose heartbeat age exceeds its stall threshold fires
    `loop_stalled_total{loop=}` + a slow-log entry, and the flag clears
    when beats resume.  `GET /debug/tasks` serves the full registry."""

    enabled: bool = True
    # watchdog sweep period
    interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("1s"))
    # default stall threshold = max(min_stall, stall_factor * period)
    # for loops that don't declare their own threshold
    stall_factor: float = 4.0
    min_stall: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("5s"))


@dataclass
class MemoryConfig:
    """[memory]: the process memory plane (common/memledger.py).
    Every byte-holding component registers a ledger account; an RSS
    sampler loop computes unattributed = RSS - Σ accounts and drives
    soft/hard pressure watermarks.  `GET /debug/memory` serves the
    account tree; memory_account_bytes{account=} / memory_rss_bytes /
    memory_unattributed_bytes land on /metrics (and therefore in the
    meta-ingest __meta table)."""

    enabled: bool = True
    # sampler period
    interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("5s"))
    # pressure watermarks on RSS; false pins memory_pressure at 0
    pressure: bool = True
    # "0" auto-derives from the box's MemTotal (soft 70%, hard 85%).
    # memory_pressure reads 0/1/2 and
    # memory_pressure_transitions_total{level=} fires once per episode.
    soft_limit: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))
    hard_limit: ReadableSize = field(
        default_factory=lambda: ReadableSize(0))
    # de-escalation margin: pressure clears only once RSS drops below
    # watermark * (1 - hysteresis), so breathing at the line is one
    # episode, not a counter flood
    hysteresis: float = 0.05


@dataclass
class DeviceprofConfig:
    """[deviceprof]: the device plane's knobs (common/deviceprof.py,
    applied by the server at start): the profiler on or off, a
    new-call-key storm watchdog and a round-timeline ring."""

    enabled: bool = True
    # recompile-storm watchdog: `storm_threshold` compiles of one fn
    # inside a sliding `storm_window` fire
    # device_recompile_storms_total{fn=} ONCE per episode plus a
    # slow-log line naming the churning cache-key dimension
    storm_window: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("60s"))
    storm_threshold: int = 5
    # mesh round timeline entries kept (FIFO) for /debug/device
    rounds: int = 256


@dataclass
class TestConfig:
    """Write-load generator (ref: config.rs:48-57)."""

    enable_write: bool = False
    write_worker_num: int = 1
    write_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(500))


@dataclass
class S3Config:
    """S3-compatible backend settings (the keys the reference defines,
    config.rs:82-160), served by objstore.s3.S3ObjectStore."""

    region: str = ""
    key_id: str = ""
    key_secret: str = ""
    endpoint: str = ""
    bucket: str = ""
    prefix: str = ""
    max_retries: int = 3


@dataclass
class ObjectStoreConfig:
    kind: str = "Local"  # "Local" | "S3Like"
    data_dir: str = "/tmp/horaedb-tpu"
    s3: Optional[S3Config] = None


@dataclass
class MetricEngineConfig:
    segment_duration: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("2h"))
    # RFC opaque-chunk data layout (Append/BytesMerge path)
    chunked_data: bool = False
    chunk_window: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("30m"))
    object_store: ObjectStoreConfig = field(default_factory=ObjectStoreConfig)
    time_merge_storage: StorageConfig = field(default_factory=StorageConfig)


@dataclass
class ServerConfig:
    port: int = 5000
    test: TestConfig = field(default_factory=TestConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    # per-tenant isolation: weighted-fair admission over per-tenant
    # queues + scan-byte / WAL-rate quotas (common/tenant.py); disabled
    # reproduces the global single-FIFO admission exactly
    tenants: TenantsConfig = field(default_factory=TenantsConfig)
    # circuit breaker / RPC policy for a cluster-backed server's
    # scatter-gather plane (applied when the served engine is a Cluster)
    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    # durable ingest: WAL + memtable front end (wal/ingest.py); with an
    # empty dir and a Local object store, `<data_dir>/wal` is derived
    wal: WalConfig = field(default_factory=WalConfig)
    # standing rollup tiers fed by the ingest path (rollup/manager.py)
    rollup: RollupConfig = field(default_factory=RollupConfig)
    # request-scoped tracing: ring size, slow-query threshold, sampling
    trace: TraceConfig = field(default_factory=TraceConfig)
    # background-loop watchdog (common/loops.py, GET /debug/tasks)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    # memory plane: ledger sampler + pressure watermarks
    # (common/memledger.py, GET /debug/memory)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    # device plane knobs (parsed, not served yet: /debug/device is 501)
    deviceprof: DeviceprofConfig = field(default_factory=DeviceprofConfig)
    # replication plane: WAL shipping + lease-fenced ownership
    # (cluster/replication.py); disabled reproduces single-copy
    # behavior bit-for-bit
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    # auto-executed rebalance envelope for survey_load recommendations
    rebalance: RebalanceConfig = field(default_factory=RebalanceConfig)
    # standby self-promotion: the follower's StandbyMonitor election
    # policy (cluster/replication.py); disabled keeps failover an
    # operator/placement-controller decision
    failover: FailoverConfig = field(default_factory=FailoverConfig)
    # self-monitoring meta-ingest (metric_engine/meta.py)
    meta: MetaConfig = field(default_factory=MetaConfig)
    # near-data scan agents: shard map + routing policy (scanagent/);
    # mode = "off" is the direct-scan bit-identity control
    scanagent: ScanAgentConfig = field(default_factory=ScanAgentConfig)
    metric_engine: MetricEngineConfig = field(default_factory=MetricEngineConfig)


@functools.lru_cache(maxsize=None)
def _hints(cls: type) -> dict[str, Any]:
    return typing.get_type_hints(cls)


def _dc_from_dict(cls: type, data: dict[str, Any]) -> Any:
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise Error(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs: dict[str, Any] = {}
    for key, value in data.items():
        where = f"{cls.__name__}.{key}"
        # dispatch durations by DECLARED type, not a name whitelist —
        # new ReadableDuration fields need no registration here
        if _hints(cls).get(key) is ReadableDuration:
            if not isinstance(value, ReadableDuration):
                ensure(isinstance(value, str),
                       f'{where} expects a duration string like "2h"')
                value = ReadableDuration.parse(value)
            kwargs[key] = value
        elif _hints(cls).get(key) is ReadableSize:
            # sizes dispatch by declared type too: "512MiB" strings or
            # bare byte integers
            if not isinstance(value, ReadableSize):
                ensure(isinstance(value, (str, int))
                       and not isinstance(value, bool),
                       f'{where} expects a size string like "512MiB" '
                       'or a byte count')
                value = (ReadableSize.parse(value)
                         if isinstance(value, str)
                         else ReadableSize(value))
            kwargs[key] = value
        elif key == "test":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(TestConfig, value)
        elif key == "admission":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(AdmissionConfig, value)
        elif key == "tenants" and cls is ServerConfig:
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = tenants_from_dict(value)
        elif key == "breaker":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(BreakerConfig, value)
        elif key == "wal":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(WalConfig, value)
        elif key == "rollup" and cls is ServerConfig:
            # ServerConfig.rollup is the [rollup] table; MetaConfig's
            # same-named field is a plain bool (the scalar path below)
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = rollup_from_dict(value)
        elif key == "trace":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(TraceConfig, value)
        elif key == "watchdog":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(WatchdogConfig, value)
        elif key == "memory" and cls is ServerConfig:
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(MemoryConfig, value)
        elif key == "deviceprof":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(DeviceprofConfig, value)
        elif key == "replication":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(ReplicationConfig, value)
        elif key == "rebalance":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(RebalanceConfig, value)
        elif key == "failover":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(FailoverConfig, value)
        elif key == "meta":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(MetaConfig, value)
        elif key == "scanagent":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = scanagent_from_dict(value)
        elif key == "metric_engine":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(MetricEngineConfig, value)
        elif key == "object_store":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(ObjectStoreConfig, value)
        elif key == "s3":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = _dc_from_dict(S3Config, value)
        elif key == "time_merge_storage":
            ensure(isinstance(value, dict), f"{where} expects a config table")
            kwargs[key] = storage_from_dict(StorageConfig, value)
        else:
            # scalar fields: validate against the declared type at load time
            kwargs[key] = _check_scalar(cls, names[key], value, where)
    return cls(**kwargs)


def load_config(path: Optional[str] = None) -> ServerConfig:
    if path is None:
        return ServerConfig()
    try:
        import tomllib  # stdlib on py3.11+
    except ModuleNotFoundError:
        # py3.10: tomllib IS tomli, and pip always vendors tomli — use
        # it rather than making config files unloadable (no installs
        # available in the deployment image)
        from pip._vendor import tomli as tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    cfg = _dc_from_dict(ServerConfig, data)
    kind = cfg.metric_engine.object_store.kind
    if kind not in ("Local", "S3Like"):
        raise Error(f"object store {kind!r} not supported "
                    "(expected Local or S3Like)")
    if kind == "S3Like":
        s3 = cfg.metric_engine.object_store.s3
        ensure(s3 is not None and s3.endpoint and s3.bucket
               and s3.key_id and s3.key_secret,
               "S3Like object store requires [metric_engine.object_store.s3] "
               "with endpoint, bucket, key_id, and key_secret")
    if cfg.wal.enabled and not cfg.wal.dir:
        # the WAL lives on local disk beside the object-store root; a
        # remote store has no local root to derive it from
        ensure(kind == "Local",
               "[wal] with an empty dir requires a Local object store "
               "(it derives <data_dir>/wal); set wal.dir explicitly")
    ensure(0.0 <= cfg.trace.sample_rate <= 1.0,
           "[trace] sample_rate must be in [0, 1]")
    ensure(cfg.trace.ring_size >= 1, "[trace] ring_size must be >= 1")
    ensure(0.0 <= cfg.trace.op_sample_rate <= 1.0,
           "[trace] op_sample_rate must be in [0, 1]")
    ensure(cfg.trace.op_ring_size >= 1,
           "[trace] op_ring_size must be >= 1")
    ensure(cfg.watchdog.stall_factor >= 1.0,
           "[watchdog] stall_factor must be >= 1")
    ensure(cfg.watchdog.interval.seconds > 0,
           "[watchdog] interval must be positive")
    ensure(cfg.memory.interval.seconds > 0,
           "[memory] interval must be positive")
    ensure(cfg.deviceprof.storm_threshold >= 2,
           "[deviceprof] storm_threshold must be >= 2 (1 would flag "
           "every cold compile as a storm)")
    ensure(cfg.deviceprof.storm_window.seconds > 0,
           "[deviceprof] storm_window must be positive")
    ensure(cfg.deviceprof.rounds >= 1,
           "[deviceprof] rounds must be >= 1")
    ensure(0.0 <= cfg.memory.hysteresis <= 0.5,
           "[memory] hysteresis must be in [0, 0.5]")
    if cfg.memory.soft_limit.bytes and cfg.memory.hard_limit.bytes:
        ensure(cfg.memory.soft_limit.bytes <= cfg.memory.hard_limit.bytes,
               "[memory] soft_limit must not exceed hard_limit")
    if cfg.replication.enabled:
        ensure(cfg.replication.lease_ttl.seconds > 0,
               "[replication] lease_ttl must be positive")
        ensure(2 * cfg.replication.renew_interval.seconds
               < cfg.replication.lease_ttl.seconds,
               "[replication] renew_interval must be under half of "
               "lease_ttl (a lease must survive one missed renewal "
               "with margin, or the fence can expire mid-flush)")
        ensure(cfg.replication.poll_interval.seconds > 0,
               "[replication] poll_interval must be positive")
        ensure(cfg.replication.max_batch_bytes >= 1,
               "[replication] max_batch_bytes must be >= 1")
        if cfg.replication.primary_url:
            ensure(bool(cfg.replication.mirror_dir),
                   "[replication] a follower (primary_url set) needs "
                   "mirror_dir for its local WAL mirror")
    if cfg.failover.enabled:
        ensure(cfg.replication.enabled,
               "[failover] requires [replication] enabled (a standby "
               "monitor watches the replication lease records)")
        ensure(bool(cfg.replication.primary_url)
               and bool(cfg.replication.mirror_dir),
               "[failover] runs on a follower: set [replication] "
               "primary_url and mirror_dir")
        ensure(cfg.failover.grace.seconds
               >= cfg.replication.renew_interval.seconds,
               "[failover] grace must be at least one [replication] "
               "renew_interval (a shorter grace window elects over a "
               "live primary's single renewal hiccup — flapping)")
        ensure(cfg.failover.check_interval.seconds > 0,
               "[failover] check_interval must be positive")
        ensure(cfg.failover.jitter >= 0.0,
               "[failover] jitter must be >= 0")
        ensure(cfg.failover.fitness_wait.seconds >= 0.0,
               "[failover] fitness_wait must be >= 0")
    if cfg.rebalance.enabled:
        ensure(cfg.rebalance.max_concurrent_moves >= 1,
               "[rebalance] max_concurrent_moves must be >= 1")
        ensure(cfg.rebalance.skew_ratio > 1.0,
               "[rebalance] skew_ratio must be > 1")
        ensure(cfg.rebalance.interval.seconds > 0,
               "[rebalance] interval must be positive")
    if cfg.meta.enabled:
        ensure(cfg.meta.interval.seconds > 0,
               "[meta] interval must be positive")
        ensure(bool(cfg.meta.metric),
               "[meta] metric must be non-empty")
        ensure(cfg.meta.max_series >= 1,
               "[meta] max_series must be >= 1")
    if cfg.rollup.enabled:
        ensure(not cfg.metric_engine.chunked_data,
               "[rollup] requires the row data layout "
               "(chunked_data = false)")
        seg = cfg.metric_engine.segment_duration.millis
        for t in cfg.rollup.tier_millis():
            ensure(seg % t == 0,
                   f"[rollup] tier {t}ms must evenly divide "
                   f"segment_duration ({seg}ms)")
    return cfg
