"""Request-lifecycle deadlines (docs/robustness.md, query-path
failure domains).

One `Deadline` is minted at HTTP ingress and threaded — via an ambient
`contextvars.ContextVar`, so layers that never knew about deadlines need
no signature changes — down through the engine, the cluster
scatter-gather, and every remote RPC:

  * `remaining()` / `budget(cap)` turn the absolute deadline into
    per-sub-call budgets (an RPC gets `min(rpc_timeout, remaining)`, so
    a retry never outlives the request that asked for it);
  * `checkpoint()` is the cooperative cancellation point sprinkled
    through long host loops (storage merge-scan segments/windows): a
    query observes its own expiry within one checkpoint interval
    instead of running a doomed scan to completion;
  * `cancel()` is the explicit token — admission shedding and client
    disconnects flip it so in-flight work can stop at its next
    checkpoint.

The contextvar propagates into `asyncio.create_task` children
automatically (context is copied at task creation), which is exactly
the fan-out shape of scatter-gather and prefetch pipelines.  Worker
-pool threads do NOT inherit it — by design: pool jobs are bounded
CPU slices and checkpointing belongs in the async loops that schedule
them.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

from horaedb_tpu_torch.common.error import Error


class DeadlineExceeded(Error):
    """A cooperative checkpoint observed an expired or cancelled
    deadline.  Subclasses Error so framework-level catches treat it as
    an ordinary failure; the server middleware maps it to HTTP 504."""


class Deadline:
    """Absolute deadline (monotonic clock) + cancellation token."""

    __slots__ = ("deadline_at", "reason", "_cancelled")

    def __init__(self, deadline_at: Optional[float],
                 reason: str = "request"):
        # None = unbounded (a pure cancellation token)
        self.deadline_at = deadline_at
        self.reason = reason
        self._cancelled = False

    @classmethod
    def after(cls, timeout_s: Optional[float],
              reason: str = "request") -> "Deadline":
        """Deadline `timeout_s` from now; None -> unbounded."""
        if timeout_s is None:
            return cls(None, reason)
        return cls(time.monotonic() + max(0.0, timeout_s), reason)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def expired(self) -> bool:
        if self._cancelled:
            return True
        return (self.deadline_at is not None
                and time.monotonic() >= self.deadline_at)

    def remaining(self) -> Optional[float]:
        """Seconds left (>= 0.0), or None when unbounded."""
        if self.deadline_at is None:
            return None
        return max(0.0, self.deadline_at - time.monotonic())

    def budget(self, cap_s: Optional[float]) -> Optional[float]:
        """Sub-call budget: the smaller of `cap_s` and the remaining
        time; None only when BOTH are unbounded.  This is what keeps a
        per-RPC timeout from outliving its request."""
        rem = self.remaining()
        if rem is None:
            return cap_s
        if cap_s is None:
            return rem
        return min(cap_s, rem)

    def check(self) -> None:
        """Raise DeadlineExceeded if cancelled or out of time."""
        if self._cancelled:
            raise DeadlineExceeded(f"{self.reason} cancelled")
        if self.deadline_at is not None \
                and time.monotonic() >= self.deadline_at:
            raise DeadlineExceeded(f"{self.reason} deadline exceeded")

    def __repr__(self) -> str:
        rem = self.remaining()
        state = "cancelled" if self._cancelled else (
            "unbounded" if rem is None else f"{rem:.3f}s left")
        return f"Deadline({self.reason}: {state})"


_CURRENT: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("horaedb_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline, or None outside any request scope."""
    return _CURRENT.get()


class deadline_scope:
    """Bind a deadline as the ambient one for the `with` body (sync or
    async code — contextvars work in both).  Re-entrant: an inner scope
    shadows, never replaces, the outer one."""

    __slots__ = ("deadline", "_token")

    def __init__(self, deadline: Optional[Deadline]):
        self.deadline = deadline
        self._token = None

    def __enter__(self) -> Optional[Deadline]:
        self._token = _CURRENT.set(self.deadline)
        return self.deadline

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


# cooperative-cancellation hooks: other ambient budgets (the tenant
# scan-byte quota, common/tenant.py) raise at the SAME checkpoints the
# deadline machinery uses, so every long host loop that is deadline
# -aware is automatically quota-aware — no second set of call sites to
# keep in sync.  Hooks must be cheap no-ops outside their own scope.
_CHECKPOINT_HOOKS: tuple = ()


def add_checkpoint_hook(fn) -> None:
    global _CHECKPOINT_HOOKS
    if fn not in _CHECKPOINT_HOOKS:
        _CHECKPOINT_HOOKS = _CHECKPOINT_HOOKS + (fn,)


def checkpoint() -> None:
    """Cooperative cancellation point: a cheap no-op when no deadline
    is bound, else raises DeadlineExceeded once it has lapsed.  Long
    host-side loops (merge-scan segments, gather merges) call this once
    per iteration.  Registered budget hooks (tenant quotas) fire here
    too, deadline bound or not."""
    dl = _CURRENT.get()
    if dl is not None:
        dl.check()
    for fn in _CHECKPOINT_HOOKS:
        fn()


def remaining_budget(cap_s: Optional[float]) -> Optional[float]:
    """`min(cap_s, ambient remaining)` — the one-liner sub-call budget.
    Returns `cap_s` unchanged when no deadline is bound."""
    dl = _CURRENT.get()
    if dl is None:
        return cap_s
    return dl.budget(cap_s)
