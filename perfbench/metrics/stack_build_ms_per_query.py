"""Host time building the fused route's round stacks, per query:
`scan_stage_seconds{stage="stack_build"}` over the window
(`storage/read.py::_build_round_stacks`), divided by the queries.
The seconds are summed over concurrent queries."""


def read(r):
    if not r.stages.get("stack_build_calls") or not r.queries:
        return None
    return r.stages.get("stack_build_s", 0.0) * 1e3 / r.queries
