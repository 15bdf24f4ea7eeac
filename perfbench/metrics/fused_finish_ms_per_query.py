"""Host time finishing the fused route's grids, per query:
`scan_stage_seconds{stage="fused_finish"}` over the window
(`storage/read.py`: the finalize through the synchronize inside
`device_aggregate`, then the empty-group drop and the last_ts rebase on
the event loop), divided by the queries."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, 'scan_stage_seconds{stage="fused_finish"}')
