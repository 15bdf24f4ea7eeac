"""The least time the card could take for the window's queries
(`perfbench/roofline.py`: each field scan's rows read once, its output
cells written once, over the published bandwidth and float32 peak),
divided by the summed time of every kernel, copy and set the profiler
saw in the window, in percent.

A segment the parts route served from its PartsMemo had no device
work: each such hit (`scan_combine_memo_hits_total`) takes a whole
segment's rows of one field off the count, which can only lower the
share.  The fused replay re-runs its rounds on the card, so a replay
hit keeps its work."""

from perfbench import roofline


def read(r):
    if r.trace is None or r.trace.device_s <= 0 or not r.queries:
        return None
    scans = r.queries * r.fields_per_query
    rows_off = r.counters.get("scan_combine_memo_hits_total", 0) \
        * r.segment_rows
    work = roofline.Work(
        rows=max(0, scans * r.scan_work.rows - int(rows_off)),
        cells=scans * r.scan_work.cells,
        outputs_per_cell=r.scan_work.outputs_per_cell)
    if work.rows == 0:
        return None
    least, _bound = roofline.least_seconds(work, 1, r.card)
    return 100.0 * least / r.trace.device_s
