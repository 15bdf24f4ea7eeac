"""Time finished pool work waited for the event loop, per query:
`span_loop_resume_seconds` over the window
(`common/runtimes.py::Runtimes.run`, from the worker's end to the
awaiting coroutine running again), divided by the queries.  Summed over
concurrent hops."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, "span_loop_resume_seconds")
