"""Host time folding the parts route's partial grids, per query:
`scan_stage_seconds{stage="combine"}` over the window
(`storage/combine.py`), divided by the queries."""


def read(r):
    if not r.stages.get("combine_calls") or not r.queries:
        return None
    return r.stages.get("combine_s", 0.0) * 1e3 / r.queries
