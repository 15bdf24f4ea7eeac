"""Host time of the fused route before its device dispatch, per query:
`scan_stage_seconds{stage="window_prep"}` over the window
(`storage/read.py::execute_aggregate_fused`: the replay check, the
cached windows, their prep and the group space, pool hops included),
divided by the queries."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, 'scan_stage_seconds{stage="window_prep"}')
