"""Host time reading segments (tier 2, then sidecars, then parquet),
per query: `scan_stage_seconds{stage="segment_read"}` over the window
(`storage/read.py::_read_segment_any`), divided by the queries.  The
seconds are summed over concurrent reads."""


def read(r):
    if not r.stages.get("segment_read_calls") or not r.queries:
        return None
    return r.stages.get("segment_read_s", 0.0) * 1e3 / r.queries
