"""Time work waited for a worker, per query: `span_pool_queue_seconds`
over the window (`common/runtimes.py::Runtimes.run`, from the submit to
the worker's start of every pool hop), divided by the queries.  Summed
over concurrent hops."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, "span_pool_queue_seconds")
