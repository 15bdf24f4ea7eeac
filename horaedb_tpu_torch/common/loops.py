"""Named background loops: the port's minimal copy of the JAX package's
loop registry (common/loops.py there), without its watchdog.

A background loop (compaction picker and executor, orphan scrubber) is
started through `loops.spawn(fn, name=...)`, which hands `fn` a
`LoopHandle` and keeps it registered while the task runs.  The loop
beats the handle once per iteration and reports each iteration's
outcome, so `loops.handles()` says which loops are alive, idle, or
failing.

Heartbeat discipline for loop authors:

  hb.beat()   at the top of every iteration
  hb.idle()   before parking on an unbounded wait (queue.get)
  hb.ok() / hb.error(exc)   the iteration's outcome
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from horaedb_tpu_torch.utils import registry

_ERRORS = registry.counter(
    "loop_errors_total", "background-loop iteration errors")


class LoopHandle:
    """One background loop's liveness record."""

    __slots__ = ("name", "task", "last_beat", "idle_flag", "last_success",
                 "iterations", "consecutive_errors", "last_error")

    def __init__(self, name: str):
        self.name = name
        self.task: Optional[asyncio.Task] = None
        self.last_beat = time.monotonic()
        self.idle_flag = False
        self.last_success: Optional[float] = None
        self.iterations = 0
        self.consecutive_errors = 0
        self.last_error: Optional[str] = None

    def beat(self) -> None:
        """Heartbeat: call at the top of every iteration."""
        self.last_beat = time.monotonic()
        self.idle_flag = False
        self.iterations += 1

    def idle(self) -> None:
        """About to park on an unbounded wait."""
        self.last_beat = time.monotonic()
        self.idle_flag = True

    def ok(self) -> None:
        self.last_success = time.monotonic()
        self.consecutive_errors = 0

    def error(self, exc: BaseException) -> None:
        self.consecutive_errors += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        _ERRORS.inc()


class LoopRegistry:
    """The process's running background loops, by name."""

    def __init__(self) -> None:
        self._handles: dict[str, LoopHandle] = {}

    def spawn(self, fn: Callable[[LoopHandle], object], *,
              name: str) -> asyncio.Task:
        """Start `fn(handle)` as a task on the running loop, registered
        under `name` until it finishes."""
        hb = LoopHandle(name)
        task = asyncio.ensure_future(fn(hb))
        hb.task = task
        self._handles[name] = hb

        def _done(_t: asyncio.Task) -> None:
            if self._handles.get(name) is hb:
                del self._handles[name]

        task.add_done_callback(_done)
        return task

    def handles(self) -> list[LoopHandle]:
        return list(self._handles.values())


loops = LoopRegistry()
