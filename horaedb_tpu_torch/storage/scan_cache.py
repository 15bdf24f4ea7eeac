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

from horaedb_tpu_torch.utils import registry, trace_add

# shared labeled families across the cache tiers (tier="hbm" here,
# tier="tier2" in storage/encoded_cache.py)
_HITS = registry.counter("scan_cache_hits_total",
                         "scan cache hits by tier").labels(tier="hbm")
_MISSES = registry.counter("scan_cache_misses_total",
                           "scan cache misses by tier").labels(tier="hbm")
_EVICTIONS = registry.counter("scan_cache_evictions_total",
                              "scan cache evictions by tier"
                              ).labels(tier="hbm")

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


class ByteLRU:
    """Byte-budgeted LRU core (event-loop owned — no lock).  Counters
    are the caller's registry counters; `trace_tier` names the
    "cache_<tier>_*" counters it adds to the ambient trace ("" = none)."""

    def __init__(self, max_bytes: int, hits=None, misses=None,
                 evictions=None, trace_tier: str = ""):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[CacheKey, tuple[object, int]]" = \
            OrderedDict()
        self._total_bytes = 0
        self._hits = hits
        self._misses = misses
        self._evictions = evictions
        self.trace_tier = trace_tier
        self.hits = 0
        self.misses = 0

    def get(self, key: CacheKey):
        entry = self._entries.get(key)
        if entry is None:
            self.record_miss()
            return None
        self._entries.move_to_end(key)
        self._count_hit(entry)
        return entry[0]

    def peek_entry(self, key: CacheKey):
        """Stats-free, recency-free lookup, for callers that must
        VALIDATE an entry before it counts as served (PartsMemo
        coverage): they account the outcome themselves through
        record_hit / record_miss."""
        entry = self._entries.get(key)
        return None if entry is None else entry[0]

    def record_miss(self) -> None:
        self.misses += 1
        if self._misses is not None:
            self._misses.inc()
        if self.trace_tier:
            trace_add(f"cache_{self.trace_tier}_misses")

    def record_hit(self, key: CacheKey) -> None:
        entry = self._entries.get(key)
        if entry is None:
            return
        self._entries.move_to_end(key)
        self._count_hit(entry)

    def _count_hit(self, entry) -> None:
        self.hits += 1
        if self._hits is not None:
            self._hits.inc()
        if self.trace_tier:
            trace_add(f"cache_{self.trace_tier}_hits")
            trace_add(f"cache_{self.trace_tier}_bytes", entry[1])

    def put(self, key: CacheKey, value, nbytes: int) -> None:
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return
        if key in self._entries:
            self._total_bytes -= self._entries.pop(key)[1]
        self._entries[key] = (value, nbytes)
        self._total_bytes += nbytes
        while self._total_bytes > self.max_bytes and self._entries:
            _, (_, evicted) = self._entries.popitem(last=False)
            self._total_bytes -= evicted
            if self._evictions is not None:
                self._evictions.inc()

    def clear(self) -> None:
        """Drop every entry.  Used by cold-path measurements and tests;
        production invalidation is structural (SST-set keys)."""
        self._entries.clear()
        self._total_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        return self._total_bytes

    def values(self) -> list:
        """Cached values in LRU order (no recency update)."""
        return [v for v, _nbytes in self._entries.values()]


class ScanCache(ByteLRU):
    """Post-merge window cache (see module docstring): the ByteLRU core
    with window-aware byte accounting and the scan_cache_* counters."""

    def __init__(self, max_bytes: int):
        super().__init__(max_bytes, hits=_HITS, misses=_MISSES,
                         evictions=_EVICTIONS, trace_tier="hbm")

    def put(self, key: CacheKey, windows: list) -> None:  # type: ignore[override]
        super().put(key, windows, windows_nbytes(windows))
