"""Resilient object-store middleware: retry, fault injection, metrics.

The engine's safety story is order-of-operations discipline; this module
adds the failure-domain hardening around it (no reference analogue —
the reference's object_store crate gets retries from the AWS SDK):

- `RetryingObjectStore`: backend-agnostic bounded retries with
  exponential backoff + jitter, a per-op deadline, and a shared retry
  *budget* (token bucket) so a store brown-out cannot amplify into a
  retry storm.  `NotFoundError` is semantic, not transient — it passes
  through untouched, as does cancellation.  The S3 backend keeps its own
  protocol-level retry loop (re-signing, multipart bookkeeping); this
  wrapper is the ONE retry layer the engine adds for every other
  backend, and is applied to the manifest plane (see storage.py).
- `FaultInjectingStore`: the single library-grade fault injector.
  Scripted one-shot/sticky faults keyed by (op, path substring) — the
  superset of the old test-local FlakyStore — plus seeded probabilistic
  faults, seeded latency injection, and crash-at-operation-index for
  the torture harness.  Faults fire either BEFORE the op (the op never
  happened) or AFTER it (the op landed but the ack was lost) — the
  distinction crash-consistency invariants care about.
- `InstrumentedStore`: per-op counters + latency histograms into
  `utils.metrics.MetricsRegistry` (exposed at /metrics).

All three wrap any `ObjectStore` and compose freely, e.g.
`InstrumentedStore(RetryingObjectStore(FaultInjectingStore(inner)))`.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.objstore.api import (
    DEFAULT_STREAM_CHUNK,
    NotFoundError,
    ObjectMeta,
    ObjectStore,
)
from horaedb_tpu_torch.objstore.memory import MemoryObjectStore
from horaedb_tpu_torch.utils import registry, tracing

OPS = ("put", "get", "get_range", "head", "delete", "list",
       "put_stream", "get_stream")


class WrappedObjectStore(ObjectStore):
    """Base delegating wrapper: every verb forwards to `inner`.

    Subclasses override `_call` (one interception point) rather than the
    six verbs, so a new verb added to the ABC cannot silently bypass a
    middleware."""

    def __init__(self, inner: ObjectStore):
        self.inner = inner

    async def _call(self, op: str, *args):
        return await getattr(self.inner, op)(*args)

    async def put(self, path: str, data: bytes) -> None:
        return await self._call("put", path, data)

    async def get(self, path: str) -> bytes:
        return await self._call("get", path)

    async def get_range(self, path: str, start: int, end: int) -> bytes:
        return await self._call("get_range", path, start, end)

    async def head(self, path: str) -> ObjectMeta:
        return await self._call("head", path)

    async def delete(self, path: str) -> None:
        return await self._call("delete", path)

    async def list(self, prefix: str) -> list[ObjectMeta]:
        return await self._call("list", prefix)

    async def put_stream(self, path: str, chunks) -> int:
        # routed through _call so middleware sees it (faults, metrics),
        # but chunk iterators are one-shot: the retry layer never
        # replays a stream, and no middleware may buffer it (the
        # backend's own put_stream owns its atomicity/cleanup story)
        return await self._call("put_stream", path, chunks)

    def get_stream(self, path: str,
                   chunk_size: int = DEFAULT_STREAM_CHUNK):
        # streamed reads delegate through _stream (the async-generator
        # twin of _call) so the INNER store's chunking survives
        # wrapping; like put_stream, streams are one-shot — the retry
        # layer never replays one (data-plane reads are single-shot by
        # the engine's retry discipline anyway)
        return self._stream("get_stream", path, chunk_size)

    async def _stream(self, op: str, path: str, chunk_size: int):
        del op  # interception point for subclasses
        async for chunk in self.inner.get_stream(path, chunk_size):
            yield chunk

    async def close(self) -> None:
        closer = getattr(self.inner, "close", None)
        if closer is not None:
            await closer()


# ---------------------------------------------------------------------------
# RetryingObjectStore
# ---------------------------------------------------------------------------

_RETRIES = registry.counter(
    "objstore_retries_total", "object-store operations retried")
_RETRY_BUDGET_EXHAUSTED = registry.counter(
    "objstore_retry_budget_exhausted_total",
    "retries suppressed because the retry budget was empty")
_DEADLINES_EXCEEDED = registry.counter(
    "objstore_deadline_exceeded_total",
    "object-store operations failed on their per-op deadline")


class DeadlineExceededError(Error):
    """Raised when an operation (including its retries) overruns the
    policy's per-op deadline.  Not retryable by construction."""


@dataclass
class RetryPolicy:
    """Knobs for RetryingObjectStore (see storage.config.RetryConfig for
    the TOML surface)."""

    max_retries: int = 2
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    # total wall-clock allowed per operation INCLUDING retries/backoff;
    # None = unbounded
    op_deadline_s: Optional[float] = None
    # token bucket shared across all ops of one store: a retry spends a
    # token, tokens refill continuously — sustained failure degrades to
    # fail-fast instead of multiplying load on a struggling backend
    budget: float = 32.0
    budget_refill_per_s: float = 4.0


class _TokenBucket:
    def __init__(self, capacity: float, refill_per_s: float):
        self.capacity = capacity
        self.refill_per_s = refill_per_s
        self.tokens = capacity
        self._last = time.monotonic()

    def take(self, n: float = 1.0) -> bool:
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._last) * self.refill_per_s)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class RetryingObjectStore(WrappedObjectStore):
    """Bounded-retry decorator for any ObjectStore.

    Retryable = any exception except NotFoundError (semantic),
    CancelledError (cooperative shutdown), and DeadlineExceededError.
    `rng` is injectable so tests (and the seeded torture harness) get
    deterministic jitter."""

    def __init__(self, inner: ObjectStore,
                 policy: Optional[RetryPolicy] = None,
                 rng: Optional[random.Random] = None):
        super().__init__(inner)
        self.policy = policy or RetryPolicy()
        self._rng = rng or random.Random()
        self._budget = _TokenBucket(self.policy.budget,
                                    self.policy.budget_refill_per_s)

    async def _call(self, op: str, *args):
        policy = self.policy
        loop = asyncio.get_running_loop()
        deadline = (loop.time() + policy.op_deadline_s
                    if policy.op_deadline_s is not None else None)
        fn = getattr(self.inner, op)
        if op == "put_stream":
            # one-shot chunk iterator: a replay would re-send nothing.
            # Single attempt, deadline still enforced.
            if deadline is not None:
                try:
                    return await asyncio.wait_for(fn(*args),
                                                  timeout=policy.op_deadline_s)
                except (TimeoutError, asyncio.TimeoutError) as e:
                    _DEADLINES_EXCEEDED.inc()
                    raise DeadlineExceededError(
                        f"objstore {op} deadline exceeded "
                        f"({policy.op_deadline_s}s)") from e
            return await fn(*args)
        attempt = 0
        while True:
            try:
                if deadline is not None:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        _DEADLINES_EXCEEDED.inc()
                        raise DeadlineExceededError(
                            f"objstore {op} deadline exceeded "
                            f"({policy.op_deadline_s}s)")
                    return await asyncio.wait_for(fn(*args),
                                                  timeout=remaining)
                return await fn(*args)
            except (NotFoundError, DeadlineExceededError,
                    asyncio.CancelledError):
                raise
            except (TimeoutError, asyncio.TimeoutError) as e:
                # with a deadline armed, wait_for's TimeoutError IS the
                # deadline firing; without one it is the backend's own
                # timeout — transient, handled below (asyncio's alias is
                # a distinct class before Python 3.11, so catch both)
                if deadline is not None and loop.time() >= deadline:
                    _DEADLINES_EXCEEDED.inc()
                    raise DeadlineExceededError(
                        f"objstore {op} deadline exceeded "
                        f"({policy.op_deadline_s}s)") from e
                attempt = self._next_attempt(op, attempt, e)
                await self._backoff(attempt, deadline, loop)
            except Exception as e:  # noqa: BLE001 — retry boundary
                attempt = self._next_attempt(op, attempt, e)
                await self._backoff(attempt, deadline, loop)

    def _next_attempt(self, op: str, attempt: int, exc: Exception) -> int:
        attempt += 1
        if attempt > self.policy.max_retries:
            raise exc
        if not self._budget.take():
            _RETRY_BUDGET_EXHAUSTED.inc()
            raise exc
        _RETRIES.inc()
        return attempt

    async def _backoff(self, attempt: int, deadline: Optional[float],
                       loop) -> None:
        backoff = min(self.policy.max_backoff_s,
                      self.policy.base_backoff_s * (2 ** (attempt - 1)))
        backoff *= 1 + self._rng.random()  # full jitter upward
        if deadline is not None:
            # never sleep past the deadline; the next loop turn raises
            backoff = min(backoff, max(0.0, deadline - loop.time()))
        await asyncio.sleep(backoff)


# ---------------------------------------------------------------------------
# FaultInjectingStore
# ---------------------------------------------------------------------------


class InjectedFault(OSError):
    """A scripted or probabilistic transient fault.  Subclasses OSError
    so code under test treats it exactly like a real backend error."""


class InjectedCrash(Exception):
    """The simulated process death.  After it fires the store is halted:
    every subsequent op raises InjectedFault, so nothing can 'survive'
    the crash by accident — state below the crash point is exactly what
    a restart would recover from."""


@dataclass
class _FaultRule:
    op: str  # one of OPS or "*"
    path_part: str
    times: int  # remaining firings; -1 = sticky
    mode: str = "before"  # "before": op never ran; "after": ack lost

    def matches(self, op: str, path: str) -> bool:
        # "put" rules cover put_stream too (and "get" covers
        # get_stream): both are object writes/reads, and which variant
        # a code path uses is an implementation detail the fault script
        # should not have to know
        op_ok = (self.op in ("*", op)
                 or (self.op == "put" and op == "put_stream")
                 or (self.op == "get" and op == "get_stream"))
        return op_ok and self.path_part in path


class FaultInjectingStore(WrappedObjectStore):
    """Library-grade fault injector (replaces the test-local FlakyStore).

    - `fail_next(op, path_part)`: scripted faults; `times=-1` is sticky,
      `after=True` applies the op then raises (lost-ack).
    - `seed` + `fault_rate`: probabilistic faults, deterministic per
      seed.  Mutating ops (put/delete) pick before/after at 50/50; reads
      always fault before (a lost read ack is indistinguishable).
    - `latency_range`: seeded uniform delay injected before each op.
    - `crash_at`: global op index at which InjectedCrash fires and the
      store halts; `revive()` clears the halt (the "restart").
    """

    def __init__(self, inner: Optional[ObjectStore] = None,
                 seed: Optional[int] = None, fault_rate: float = 0.0,
                 latency_range: tuple[float, float] = (0.0, 0.0),
                 crash_at: Optional[int] = None):
        super().__init__(inner if inner is not None else MemoryObjectStore())
        self._rules: list[_FaultRule] = []
        self._rng = random.Random(seed)
        self.fault_rate = fault_rate
        self.latency_range = latency_range
        self.crash_at = crash_at
        self.ops_seen = 0
        self.halted = False

    # -- scripting ---------------------------------------------------------

    def fail_next(self, op: str, path_part: str, times: int = 1,
                  after: bool = False) -> None:
        self._rules.append(_FaultRule(op=op, path_part=path_part,
                                      times=times,
                                      mode="after" if after else "before"))

    def clear_faults(self) -> None:
        self._rules = []

    def crash(self) -> None:
        self.halted = True

    def revive(self) -> None:
        self.halted = False
        self.crash_at = None

    # -- injection ---------------------------------------------------------

    def _scripted(self, op: str, path: str) -> Optional[str]:
        """First matching rule's mode, consuming one firing."""
        for i, rule in enumerate(self._rules):
            if rule.matches(op, path):
                if rule.times > 0:
                    rule.times -= 1
                    if rule.times == 0:
                        del self._rules[i]
                return rule.mode
        return None

    def _probabilistic(self, op: str) -> Optional[str]:
        if self.fault_rate and self._rng.random() < self.fault_rate:
            if (op in ("put", "delete", "put_stream")
                    and self._rng.random() < 0.5):
                return "after"
            return "before"
        return None

    async def _call(self, op: str, *args):
        path = args[0] if args else ""
        if self.halted:
            raise InjectedFault(f"store halted (crashed): {op} {path}")
        self.ops_seen += 1
        if self.latency_range[1] > 0:
            await asyncio.sleep(self._rng.uniform(*self.latency_range))

        crash = self.crash_at is not None and self.ops_seen >= self.crash_at
        if crash:
            # a crash straddles the op like any fault: before = the op
            # never hit the backend, after = it landed but the process
            # died before acting on the response
            mode = ("after" if op in ("put", "delete", "put_stream")
                    and self._rng.random() < 0.5 else "before")
            if mode == "before":
                self.crash()
                raise InjectedCrash(f"crash before {op} {path}")
            await super()._call(op, *args)
            self.crash()
            raise InjectedCrash(f"crash after {op} {path}")

        mode = self._scripted(op, path) or self._probabilistic(op)
        if mode == "before":
            raise InjectedFault(f"injected {op} failure for {path}")
        result = await super()._call(op, *args)
        if mode == "after":
            raise InjectedFault(f"injected lost-ack {op} failure for {path}")
        return result

    async def _stream(self, op: str, path: str, chunk_size: int):
        """Streamed reads take the same injection points as get: the
        fault/crash fires at stream START (a read that dies mid-stream
        is indistinguishable from one that never started — callers see
        an exception either way, and reads have no ack to lose)."""
        if self.halted:
            raise InjectedFault(f"store halted (crashed): {op} {path}")
        self.ops_seen += 1
        if self.latency_range[1] > 0:
            await asyncio.sleep(self._rng.uniform(*self.latency_range))
        if self.crash_at is not None and self.ops_seen >= self.crash_at:
            self.crash()
            raise InjectedCrash(f"crash before {op} {path}")
        mode = self._scripted(op, path) or self._probabilistic(op)
        if mode is not None:
            raise InjectedFault(f"injected {op} failure for {path}")
        async for chunk in self.inner.get_stream(path, chunk_size):
            yield chunk


# ---------------------------------------------------------------------------
# InstrumentedStore
# ---------------------------------------------------------------------------


class InstrumentedStore(WrappedObjectStore):
    """Counts and times every op into a MetricsRegistry:

        objstore_<op>_total, objstore_<op>_errors_total,
        objstore_<op>_seconds (histogram)

    NotFoundError counts in _total but not _errors_total — a missing key
    is an answer, not a failure.

    When a request trace is ambient (utils.tracing), each op is ALSO
    attributed to it: `objstore_<op>_total`, wall ms, and — for
    get/get_range — `objstore_get_bytes`, so `/debug/traces/{id}`
    shows exactly how much store IO one query paid.  Ops after the
    trace finished attribute to nothing (the Trace drops late adds)."""

    def __init__(self, inner: ObjectStore, metrics=None,
                 prefix: str = "objstore"):
        super().__init__(inner)
        metrics = metrics if metrics is not None else registry
        self._ops = {}
        for op in OPS:
            self._ops[op] = (
                metrics.counter(f"{prefix}_{op}_total",
                                f"object-store {op} calls"),
                metrics.counter(f"{prefix}_{op}_errors_total",
                                f"object-store {op} failures"),
                metrics.histogram(f"{prefix}_{op}_seconds",
                                  f"object-store {op} latency"),
            )

    async def _call(self, op: str, *args):
        total, errors, seconds = self._ops[op]
        total.inc()
        t0 = time.perf_counter()
        result = None
        try:
            result = await super()._call(op, *args)
            return result
        except NotFoundError:
            raise
        except BaseException:
            errors.inc()
            raise
        finally:
            dt = time.perf_counter() - t0
            seconds.observe(dt)
            if tracing.active_trace() is not None:
                tracing.trace_add(f"objstore_{op}_total")
                tracing.trace_add(f"objstore_{op}_ms", dt * 1e3)
                if op in ("get", "get_range") and isinstance(
                        result, (bytes, bytearray)):
                    tracing.trace_add("objstore_get_bytes", len(result))

    async def _stream(self, op: str, path: str, chunk_size: int):
        """One get_stream op = one timed entry covering the full drain,
        with get-style byte attribution summed over chunks."""
        total, errors, seconds = self._ops["get_stream"]
        total.inc()
        t0 = time.perf_counter()
        nbytes = 0
        try:
            async for chunk in self.inner.get_stream(path, chunk_size):
                nbytes += len(chunk)
                yield chunk
        except NotFoundError:
            raise
        except BaseException:
            errors.inc()
            raise
        finally:
            dt = time.perf_counter() - t0
            seconds.observe(dt)
            if tracing.active_trace() is not None:
                tracing.trace_add("objstore_get_stream_total")
                tracing.trace_add("objstore_get_stream_ms", dt * 1e3)
                tracing.trace_add("objstore_get_bytes", nbytes)
