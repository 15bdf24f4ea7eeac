"""Per-region circuit breaker for the scatter-gather plane
(docs/robustness.md, query-path failure domains).

HoraeDB's design treats the query plane as a failure domain with
fail-fast routing (SURVEY.md P6); the breaker is the per-region piece:
after `failure_threshold` CONSECUTIVE failures (RPC errors, timeouts,
or failed heartbeat pings) a region's circuit opens and gather skips it
immediately — no connect attempts, no timeout waits — reporting it in
`missing_regions` instead of stalling the whole query.

State machine:

    closed ── failures >= threshold ──> open
    open ── cooldown elapsed OR health-monitor ping OK ──> half_open
    half_open ── one probe query succeeds ──> closed
    half_open ── probe fails ──> open (cooldown restarts)

The half-open probe "rides the existing health monitor" two ways: a
successful ping promotes open -> half_open without waiting out the
cooldown, and the NEXT real query is the single admitted probe.  All
transitions feed /metrics counters so open/half-open/close flapping is
observable in production.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.utils import registry

# one labeled family per event kind (docs/observability.md label
# conventions): per-region + per-target-state series replace the old
# per-state metric-name one-offs
_TRANSITIONS = registry.counter(
    "cluster_breaker_transitions_total",
    "circuit breaker state transitions by region and target state")
_REJECTED = registry.counter(
    "cluster_breaker_rejected_total",
    "region calls skipped because the circuit was open, by region")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class BreakerConfig:
    """[breaker] config: per-region circuit breaking + the RPC-level
    timeout/retry/hedge policy the gather path applies around remote
    region calls."""

    enabled: bool = True
    # consecutive failures (errors, timeouts, failed pings) that open
    # the circuit
    failure_threshold: int = 3
    # how long an open circuit waits before admitting a probe on its
    # own (a successful health-monitor ping short-circuits the wait)
    open_cooldown: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("10s"))
    # per-attempt remote RPC timeout; the effective budget is
    # min(rpc_timeout, deadline remaining)
    rpc_timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("10s"))
    # bounded retry count for idempotent reads (writes never retry)
    retries: int = 1
    # hedged reads: after this delay with no response, fire a second
    # identical request and take whichever succeeds first.  0 disables.
    hedge_delay: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(0))


class CircuitBreaker:
    """One region's breaker.  Thread-safe (the health monitor and
    gather tasks share it), but all users run on one event loop in
    practice."""

    def __init__(self, name: str, config: BreakerConfig | None = None,
                 clock=time.monotonic):
        self.name = name
        self.config = config or BreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        # labeled children bound once (label lookup off the hot path)
        self._m_opened = _TRANSITIONS.labels(region=name, to=OPEN)
        self._m_half_open = _TRANSITIONS.labels(region=name, to=HALF_OPEN)
        self._m_closed = _TRANSITIONS.labels(region=name, to=CLOSED)
        self._m_rejected = _REJECTED.labels(region=name)

    @property
    def state(self) -> str:
        with self._lock:
            # surface the lazy open -> half_open cooldown transition
            if self._state == OPEN and self._cooldown_elapsed():
                return HALF_OPEN
            return self._state

    def _cooldown_elapsed(self) -> bool:
        return (self._clock() - self._opened_at
                >= self.config.open_cooldown.seconds)

    def allow(self) -> bool:
        """Whether a call may proceed.  In half-open exactly ONE probe
        is admitted at a time; its outcome decides the next state."""
        if not self.config.enabled:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if not self._cooldown_elapsed():
                    self._m_rejected.inc()
                    return False
                self._to_half_open_locked()
            # half-open: admit a single probe
            if self._probe_inflight:
                self._m_rejected.inc()
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._state = CLOSED
                self._m_closed.inc()

    def record_failure(self) -> None:
        if not self.config.enabled:
            return  # a disabled breaker must not open (nor suppress
            # the gather's bounded retries via a non-closed state)
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                # failed probe: back to open, cooldown restarts
                self._to_open_locked()
                return
            self._failures += 1
            if (self._state == CLOSED
                    and self._failures >= self.config.failure_threshold):
                self._to_open_locked()

    def abort_probe(self) -> None:
        """Release a claimed probe slot with NO outcome recorded — the
        probe never actually ran (its requester's deadline expired, or
        its task was cancelled).  Without this, a half-open breaker
        whose probe evaporated would reject every caller until a ping
        re-armed it."""
        with self._lock:
            self._probe_inflight = False

    def on_ping_ok(self) -> None:
        """A health-monitor ping succeeded: an open circuit moves to
        half-open immediately (the probe rides the monitor instead of
        waiting out the cooldown); a closed circuit forgets stale
        failures so unrelated blips can't accumulate into an open.  In
        half-open the probe slot is re-armed: a probe whose task died
        between allow() and its outcome (cancelled gather) must not
        wedge the breaker rejecting forever while the peer answers
        pings."""
        with self._lock:
            if self._state == OPEN:
                self._to_half_open_locked()
            elif self._state == HALF_OPEN:
                self._probe_inflight = False
            elif self._state == CLOSED:
                self._failures = 0

    def _to_open_locked(self) -> None:
        self._state = OPEN
        self._failures = 0
        self._opened_at = self._clock()
        self._probe_inflight = False
        self._m_opened.inc()

    def _to_half_open_locked(self) -> None:
        self._state = HALF_OPEN
        self._probe_inflight = False
        self._m_half_open.inc()

    def __repr__(self) -> str:
        return f"CircuitBreaker({self.name}: {self.state})"
