"""Named worker pools — the reference's dedicated runtimes.

The reference serves queries on the main tokio runtime and pins
manifest folds and SST compaction onto separate runtimes so a long
compaction cannot starve serving (ref: src/storage/src/storage.rs:91-104,
src/server/src/main.rs:104-109 builds them from
threads.manifest_thread_num / threads.sst_thread_num).

The asyncio analogue: the event loop stays an I/O scheduler only, and
every CPU-heavy step — parquet encode/decode, host merge, numpy window
prep, device dispatch + blocking syncs — runs on one of these pools via
run_in_executor.  Pools:

  sst      — serving reads/writes (parquet decode/encode, merge prep)
  compact  — compaction rewrites (so they queue behind each other, not
             in front of serving work)
  manifest — manifest codec/folds
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable


class Runtimes:
    """Owner of the named pools.  `close()` only shuts down pools this
    instance created (a sharing parent keeps ownership)."""

    def __init__(self, sst_threads: int = 4, compact_threads: int = 2,
                 manifest_threads: int = 1):
        self._pools = {
            "sst": ThreadPoolExecutor(sst_threads,
                                      thread_name_prefix="horaedb-sst"),
            "compact": ThreadPoolExecutor(
                compact_threads, thread_name_prefix="horaedb-compact"),
            "manifest": ThreadPoolExecutor(
                manifest_threads, thread_name_prefix="horaedb-manifest"),
        }

    async def run(self, pool: str, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs) on the named pool; await the result.
        The caller's contextvars context rides along (run_in_executor,
        unlike asyncio.to_thread, does not copy it) so request-scoped
        state — the ambient trace, deadline — stays visible to stage
        attribution inside pool work."""
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            self._pools[pool],
            functools.partial(ctx.run,
                              functools.partial(fn, *args, **kwargs)))

    def close(self) -> None:
        # wait=True is load-bearing: shutdown(wait=False) leaves an
        # in-flight parquet encode/merge running on the worker thread
        # AFTER the owner tears down the engine — the job then races
        # object teardown and corrupts the heap (observed as later
        # segfaults/aborts inside pyarrow).  Queued-but-unstarted jobs
        # are cancelled; the bounded in-flight ones finish first.
        for pool in self._pools.values():
            pool.shutdown(wait=True, cancel_futures=True)


def from_config(threads, sst_override: int = 0) -> Runtimes:
    """Build pools from a ThreadsConfig (storage.config).
    `sst_override` > 0 widens/narrows the serving decode pool — the
    [scan] decode_workers knob for cold-path tuning."""
    return Runtimes(sst_threads=sst_override or threads.sst_thread_num,
                    compact_threads=threads.compact_thread_num,
                    manifest_threads=threads.manifest_thread_num)
