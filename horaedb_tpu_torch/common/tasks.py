"""Reliable cancellation of background loop tasks.

Python < 3.12's `asyncio.wait_for` can SWALLOW a cancellation: when the
inner future completes in the same event-loop tick as the cancel
(bpo-37658), wait_for returns the result and the task keeps running —
with the one-shot `Task.cancel()` already spent.  Every background loop
here waits on a signal queue via wait_for, and signals race shutdown
by construction (a failed compaction's trigger_more vs close()), so
`cancel(); await task` can hang forever on a loop that went back to
sleep for an hour.  The torture harness (tests/test_torture.py) finds
this in a few hundred schedules.

`cancel_and_wait` re-delivers the cancel until the task actually
finishes — each retry lands while the task is parked at an await, where
cancellation cannot be swallowed twice in a row by the same race.
"""

from __future__ import annotations

import asyncio


async def cancel_and_wait(task: asyncio.Task,
                          poll_s: float = 0.05) -> None:
    """Cancel `task` and wait for it to finish, re-cancelling if a
    wait_for race swallowed the first delivery.  Never raises the
    task's CancelledError into the caller."""
    while not task.done():
        task.cancel()
        # asyncio.wait never raises; it returns on completion or timeout
        await asyncio.wait([task], timeout=poll_s)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None and not isinstance(exc, asyncio.CancelledError):
        raise exc
