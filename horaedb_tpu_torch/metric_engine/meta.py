"""Self-monitoring meta-ingest: the engine stores its own health
history (docs/observability.md, background plane).

A background loop scrapes the process's `MetricsRegistry` — every
counter, gauge and histogram sum/count the engine already maintains
(WAL backlog, cache hit rates, loop heartbeat ages, compaction counts)
— into an ordinary metrics table (default name `__meta`) THROUGH the
normal write path: WAL group commit, memtables, flush, rollups.  Each
scraped series becomes one sample of the `__meta` metric tagged
`name=<series_name>` plus the series' own labels, so operators query
the engine's health history with the engine's own query path:

    POST /query {"metric": "__meta",
                 "filters": {"name": "wal_backlog_bytes"},
                 "start": ..., "end": ..., "bucket_ms": 60000}

and — because a standing rollup is registered on `__meta` when rollups
are enabled — dashboard-shaped health queries are rollup-served like
any tenant metric.  The loop is also a standing end-to-end workload
continuously exercising ingest -> flush -> rollup, which means a broken
write path shows up as meta-ingest loop errors in /debug/tasks before
a tenant notices.

Guards (the "never recurses, never starves" contract, held against the
JAX package by tests/test_torch_meta.py):

- the registry snapshot is taken BEFORE the write, so metrics the
  write itself bumps (wal_appends_total, memtable counters...) land in
  the NEXT scrape — a scrape can never observe, and re-write, its own
  side effects in the same pass (no meta-about-meta recursion);
- a scrape is skipped (and counted) while the previous one's write is
  still in flight — backpressure can delay health history, never queue
  an unbounded backlog of it;
- at most `max_series` samples per scrape (series are operator-bounded
  registry families, but the cap is a hard backstop), and scrapes run
  on a fixed interval — meta traffic is a small constant tax, not a
  function of tenant load.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Optional

from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.tasks import cancel_and_wait
from horaedb_tpu_torch.common.time_ext import ReadableDuration, now_ms
from horaedb_tpu_torch.utils import op_trace, registry

logger = logging.getLogger(__name__)

_SCRAPES = registry.counter(
    "meta_scrapes_total", "meta-ingest scrape passes written")
_SCRAPES_SKIPPED = registry.counter(
    "meta_scrapes_skipped_total",
    "meta-ingest scrapes skipped because the previous write was still "
    "in flight (backpressure guard)")
_SAMPLES_WRITTEN = registry.counter(
    "meta_samples_written_total",
    "health samples written to the meta metrics table")
_SAMPLES_DROPPED = registry.counter(
    "meta_samples_dropped_total",
    "scraped series dropped by the max_series cap or a label collision")
_SCRAPE_ERRORS = registry.counter(
    "meta_scrape_errors_total", "meta-ingest scrape passes that failed")


@dataclass
class MetaConfig:
    """[meta]: self-monitoring meta-ingest (docs/observability.md).
    Off by default — it writes real rows through the real write path,
    which is the point, but an operator should opt in."""

    enabled: bool = False
    # scrape period; also the meta loop's heartbeat period
    interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("10s"))
    # the metrics-table name health samples are written under
    metric: str = "__meta"
    # hard cap on samples per scrape (registry families are
    # operator-bounded; this is the backstop, not the budget)
    max_series: int = 4096
    # register a standing rollup on the meta metric when rollups are
    # enabled, so health dashboards are rollup-served
    rollup: bool = True


class MetaIngest:
    """Owns the scrape loop.  `scrape_once()` is the test/ops surface —
    one snapshot + one engine.write, with the recursion and
    backpressure guards applied."""

    def __init__(self, engine, config: MetaConfig, clock=now_ms):
        self._engine = engine
        self.config = config
        self._clock = clock
        self._task: Optional[asyncio.Task] = None
        self._writing = False
        self.paused = False  # bench A/B hook (config 12)

    async def start(self) -> None:
        if self.config.rollup and self._engine.rollups is not None:
            # health history serves like any tenant dashboard
            await self._engine.rollups.register(self.config.metric,
                                                "value")
        self._task = loops.spawn(
            self._loop, name="meta-ingest", owner="meta",
            period_s=self.config.interval.seconds,
            backlog=lambda: {"paused": self.paused,
                             "writing": self._writing})

    async def stop(self) -> None:
        if self._task is not None:
            await cancel_and_wait(self._task)
            self._task = None

    async def _loop(self, hb) -> None:
        interval = self.config.interval.seconds
        while True:
            await asyncio.sleep(interval)
            hb.beat()
            if self.paused:
                continue
            try:
                await self.scrape_once()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — retried next tick
                hb.error(exc)
                _SCRAPE_ERRORS.inc()
                logger.exception("meta-ingest scrape failed")

    def snapshot_samples(self) -> list:
        """The scrape snapshot: registry samples as engine Samples,
        capped at max_series.  A series whose own labels already carry
        a `name` key cannot be represented (the meta tag would collide)
        and is dropped + counted."""
        from horaedb_tpu_torch.metric_engine.types import Label, Sample

        ts = int(self._clock())
        cap = self.config.max_series
        out = []
        dropped = 0
        for name, labels, value in registry.samples():
            if len(out) >= cap:
                dropped += 1
                continue
            if "name" in labels:
                dropped += 1
                continue
            try:
                v = float(value)
            except (TypeError, ValueError):
                dropped += 1
                continue
            if v != v or v in (float("inf"), float("-inf")):
                dropped += 1
                continue
            labs = sorted([Label("name", name)]
                          + [Label(k, str(lv)) for k, lv in labels.items()],
                          key=lambda l: l.name)
            out.append(Sample(name=self.config.metric, labels=labs,
                              timestamp=ts, value=v))
        if dropped:
            _SAMPLES_DROPPED.inc(dropped)
        return out

    async def scrape_once(self) -> int:
        """One scrape pass: snapshot-then-write.  Returns samples
        written (0 when skipped by the in-flight guard)."""
        if self._writing:
            # the previous pass's write hasn't finished (or something
            # re-entered us from inside the write path): skip — meta
            # traffic must never queue behind itself
            _SCRAPES_SKIPPED.inc()
            return 0
        self._writing = True
        try:
            # snapshot BEFORE writing: whatever the write bumps is next
            # pass's news, never this pass's payload (recursion guard)
            with op_trace("meta_scrape", slow_s=30.0):
                samples = self.snapshot_samples()
                if samples:
                    await self._engine.write(samples)
            _SCRAPES.inc()
            _SAMPLES_WRITTEN.inc(len(samples))
            return len(samples)
        finally:
            self._writing = False
