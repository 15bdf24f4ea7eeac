"""The least time a card could take for a query's work, from the
query's shape alone, whatever kernels the program uses.

A downsample query reads, for each field it asks, the rows its window
holds: a time offset, a series and a value at 4 bytes each, each read
once.  It writes each output cell once: one 4-byte number for each
aggregate asked and one for the count.  Its operations are two a row
(the count and the sum) and one a cell (the division of the mean).
The least time is the larger of the bytes over the card's bandwidth
and the operations over its float32 peak."""

from __future__ import annotations

from dataclasses import dataclass

# Published peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W
# power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}

BYTES_PER_ROW = 12
BYTES_PER_CELL_VALUE = 4


@dataclass
class Work:
    rows: int = 0
    cells: int = 0
    outputs_per_cell: int = 0

    @property
    def bytes(self) -> int:
        return (self.rows * BYTES_PER_ROW
                + self.cells * self.outputs_per_cell * BYTES_PER_CELL_VALUE)

    @property
    def flops(self) -> int:
        return 2 * self.rows + self.cells


def field_scan_work(hosts: int, window_ms: int, interval_ms: int,
                    bucket_ms: int, aggs: list) -> Work:
    """One field's scan of one query: every host reports at every tick,
    so a window of `window_ms` holds window_ms / interval_ms rows a
    host."""
    buckets = -(-window_ms // bucket_ms)
    return Work(rows=hosts * (window_ms // interval_ms),
                cells=hosts * buckets,
                outputs_per_cell=len(set(aggs) | {"count"}))


def least_seconds(work: Work, scans: int, card: str) -> tuple:
    """(seconds, bound) for `scans` field scans of `work`."""
    peak = PEAKS[card]
    mem = scans * work.bytes / peak["hbm_bytes_per_s"]
    ops = scans * work.flops / peak["fp32_flops_per_s"]
    return (mem, "memory") if mem >= ops else (ops, "compute")
