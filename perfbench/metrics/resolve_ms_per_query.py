"""Host time resolving a query's metric, series and predicate, per query:
`span_resolve_seconds` over the window (`MetricEngine.query_downsample`
and `query_downsample_multi`, the `resolve` span around the metric and
index lookups), divided by the queries."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, "span_resolve_seconds")
