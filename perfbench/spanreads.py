"""What the per-layer readers of the program's spans and stages share:
one series of the program's registry (`Readings.counters`, the window's
delta of `registry.snapshot()`, where a histogram reads its sum of
seconds), in ms a query.

A series the window did not move reads 0.0 if the program has it, and
None if it has not (a program without the span or the stage), as when
no query completed."""


def program_has(series: str) -> bool:
    from horaedb_tpu_torch.utils.metrics import registry

    return series in registry.snapshot()


def ms_per_query(r, series: str):
    if not r.queries:
        return None
    if series not in r.counters and not program_has(series):
        return None
    return r.counters.get(series, 0.0) * 1e3 / r.queries
