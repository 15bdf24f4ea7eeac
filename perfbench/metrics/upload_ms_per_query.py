"""Host wall of the host-to-device copies, per query:
`device_transfer_seconds_total{direction="h2d"}` over the window
(`ops/encode.py::to_device`, charged to the device profiler), divided
by the queries.  Summed over concurrent uploads."""

from perfbench.spanreads import ms_per_query


def read(r):
    return ms_per_query(r, 'device_transfer_seconds_total{direction="h2d"}')
