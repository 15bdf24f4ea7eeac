"""Host time planning each field's scan, per query:
`span_plan_seconds` over the window (`MetricEngine._scan_downsample`,
the `plan` span around `plan_query`, once per field), divided by the
queries."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, "span_plan_seconds")
