"""Post-merge window cache.

Each segment's POST-MERGE windows are cached under

    (segment_start, frozenset of SST ids, column tuple)

so correctness falls out structurally: any write changes the segment's
SST set and therefore misses the cache (no explicit invalidation hooks,
no staleness).  Predicates and aggregation run AFTER the merge, so one
cached entry serves every query shape over the same data — a repeat
aggregate skips the read and the merge and goes straight to the fused
device rounds.

Eviction is LRU by total cached BYTES: column buffers at their padded
widths plus an allowance for the per-window memos (each memo slot can
hold a capacity-sized gid array).
"""

from __future__ import annotations

from collections import OrderedDict

from horaedb_tpu_torch.utils import registry

_HITS = registry.counter("scan_cache_hits_total", "scan cache hits")
_MISSES = registry.counter("scan_cache_misses_total", "scan cache misses")
_EVICTIONS = registry.counter("scan_cache_evictions_total",
                              "scan cache evictions")

CacheKey = tuple

# DeviceBatch.memo allowance multiplier: the reader's byte-bounded memo
# store (storage.read._memo_store) caps each window's memo values at
# MEMO_SLOTS * (capacity*4 + 128) real bytes
MEMO_SLOTS = 4


def segment_cache_key(segment_start: int, sst_ids, columns) -> CacheKey:
    return (segment_start, frozenset(sst_ids), tuple(columns))


def windows_nbytes(windows: list) -> int:
    """Cost of a cached entry: every column buffer at its padded width,
    plus the memo allowance per window."""
    total = 0
    for w in windows:
        for col in w.columns.values():
            total += int(col.dtype.itemsize) * w.capacity
        total += MEMO_SLOTS * (w.capacity * 4 + 128)
    return total


class ScanCache:
    """Byte-budgeted LRU of post-merge windows (event-loop owned — no
    lock)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[CacheKey, tuple[list, int]]" = \
            OrderedDict()
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: CacheKey):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            _MISSES.inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        _HITS.inc()
        return entry[0]

    def put(self, key: CacheKey, windows: list) -> None:
        nbytes = windows_nbytes(windows)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return
        if key in self._entries:
            self._total_bytes -= self._entries.pop(key)[1]
        self._entries[key] = (windows, nbytes)
        self._total_bytes += nbytes
        while self._total_bytes > self.max_bytes and self._entries:
            _, (_, evicted) = self._entries.popitem(last=False)
            self._total_bytes -= evicted
            _EVICTIONS.inc()

    def clear(self) -> None:
        """Drop every entry.  Used by cold-path measurements and tests;
        production invalidation is structural (SST-set keys)."""
        self._entries.clear()
        self._total_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def values(self) -> list:
        """Cached window lists in LRU order (no recency update)."""
        return [v for v, _nbytes in self._entries.values()]
