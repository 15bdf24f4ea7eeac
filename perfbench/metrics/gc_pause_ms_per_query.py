"""Python's garbage-collector pauses, per query: `span_gc_pause_seconds`
over the window (`utils/tracing.py`, a `gc.callbacks` hook while an
engine is open; every thread of the process stops for a collection),
divided by the queries."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, "span_gc_pause_seconds")
