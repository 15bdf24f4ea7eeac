"""Process-wide monotonic id allocation.

Both SST file ids and manifest delta filenames come from wall-clock-seeded
monotonic u64 counters ("mustn't go backwards on restarts", ref:
src/storage/src/sst.rs:36-46, manifest/mod.rs:52-63): monotonicity across
restarts is what makes a file id usable as the write sequence.
"""

from __future__ import annotations

import itertools
import threading
import time

_U64_MASK = (1 << 64) - 1


class MonotonicIdAllocator:
    def __init__(self) -> None:
        self._counter = itertools.count(time.time_ns() & _U64_MASK)
        self._lock = threading.Lock()

    def allocate(self) -> int:
        with self._lock:
            return next(self._counter) & _U64_MASK
